#!/usr/bin/env python3
"""The card's run-to-run noise of cli/train, and a resume's distance from
the straight run (ROADMAP fault 4), on one CUDA card.

Run A as chip_smoke.py phase 13 runs it (ResNet-50, B=64, 224 px, 4
steps, validation and a checkpoint at steps 2 and 4), then REPEATS times
each: B, A again in a new log directory, and C, A resumed from its step-2
checkpoint. Prints, per repeat, each part's distance from A (parameters,
Adam's moments, fits: max abs relative to each tensor's largest), whether
it is within chip_smoke.RESUME_BAR and its Adam count and dropout generator
equal A's, and each step's largest relative loss difference, the total
loss and the largest component apart.

    python3 tools/resume_noise.py [REPEATS]     # from the repository root
"""

import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    import chip_smoke as CS
    if not torch.cuda.is_available():
        print('resume_noise: no CUDA device; nothing was run',
              file=sys.stderr)
        return 1
    from tuch_tpu_torch import runtime as rt
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    print(CS.card_line(), flush=True)
    fit_rt = rt.build_runtime(device=CS.DEV, synthetic=True,
                              with_contact=True, with_hd=True)
    counters = CS.train_counters()
    shutil.rmtree(CS.TRAIN_LOG_DIR, ignore_errors=True)

    def hmr():
        return rt.build_runtime(device=CS.DEV, synthetic=True).hmr

    A, _, _ = CS.train_run('A', 'resnet50', fit_rt, hmr(), counters)
    want = CS._state_tensors(A)
    recs_a, _ = CS._train_records(A)
    step2 = A.ckpt.list_checkpoints()[0]
    for i in range(repeats):
        for tag, flags, steps in (('B', (), (1, 2, 3, 4)),
                                  ('C', ('--resume', '--checkpoint', step2),
                                   (3, 4))):
            tr, _, _ = CS.train_run(f'{tag}{i}', 'resnet50', fit_rt, hmr(),
                                    counters, *flags)
            parts, equal = CS._distance(CS._state_tensors(tr), want)
            recs, _ = CS._train_records(tr)
            gaps = {st: CS._loss_gaps(recs, recs_a, (st,)) for st in steps}
            within = all(parts[k] <= bar for k, bar in CS.RESUME_BAR.items())
            same = (tr.state.opt.count == A.state.opt.count and torch.equal(
                tr.state.generator.get_state(),
                A.state.generator.get_state()))
            print(json.dumps({'run': f'{tag}{i}', 'bit_for_bit': equal,
                              'distance': parts, 'within_bar': within,
                              'count_and_generator': bool(same),
                              'loss_gaps': gaps}), flush=True)
            del tr
    shutil.rmtree(CS.TRAIN_LOG_DIR, ignore_errors=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
