#!/usr/bin/env python3
"""The readings that decide `correct` in fit.hmr2_vith16.eft_b1, over many
seeds in one process.

    python3 tools/hmr2_fit_spread.py [N] [FIRST_SEED]   # repository root,
                                                       # one card
    python3 tools/hmr2_fit_spread.py --seeds S1,S2 [--repeat K]
        [--no-control] [--plain-attention] [--loss-fault F1,F2]

Sets the cell up once (portbench/drivers/fit_hmr2.Cell: HMR 2.0 at its
published widths, the warm-up image and the graphs' capture), then for each
seed (N of them from FIRST_SEED, or those of --seeds): loads the seed's
weights and folding start, fits the seed's image 0 as the configuration
states it (float32, TF32 off; K times with --repeat) and as its control
(TF32 on; not with --no-control), each recorded as the cell's window
records its first image (fit_hmr2.FirstFit), follows the same image with
the plain reference (fit_hmr2.follow), and prints each gap of the cell's
comparison (fit_hmr2.compare) for the program and for the control beside
the traffic's limits; then the largest of each gap over the seeds, and
the smallest of the control's.

--plain-attention sends the program's attention (models/vit.fused_mha) to
ops/attention.mha_reference before the set-up, so kernel 1 runs nowhere
(the counter's launches are printed). --loss-fault plants a fault: the
program's EFT loss (fitting/eft.eft_loss) times each factor, fitted on
every seed after the program and read as the program is (factor 1 for the
program's own fits).
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402

run.set_environment()

from portbench.drivers import fit as F  # noqa: E402
from portbench.drivers import fit_hmr2 as D  # noqa: E402
from portbench.reference.tuchref.fitting import eft as reft  # noqa: E402

CELL = 'fit.hmr2_vith16.eft_b1'
DEVICE = 'cuda'


def plant_loss_fault():
    """The program's EFT loss times factor[0] (1 until it is changed)."""
    from tuch_tpu_torch.fitting import eft
    loss, factor = eft.eft_loss, [1.0]

    def faulty(*args, **kwargs):
        total, parts = loss(*args, **kwargs)
        return total * factor[0], parts
    eft.eft_loss = faulty
    return factor


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument('n', type=int, nargs='?', default=6)
    p.add_argument('first', type=int, nargs='?', default=2 ** 31 + 1000)
    p.add_argument('--seeds', help='comma-separated seeds, in place of N '
                                   'and FIRST_SEED')
    p.add_argument('--repeat', type=int, default=1,
                   help="the program's fits of each seed")
    p.add_argument('--no-control', action='store_true')
    p.add_argument('--plain-attention', action='store_true')
    p.add_argument('--loss-fault', default='',
                   help='comma-separated factors of the planted loss fault')
    args = p.parse_args()
    seeds = ([int(s) for s in args.seeds.split(',')] if args.seeds
             else list(range(args.first, args.first + args.n)))
    faults = [float(f) for f in args.loss_fault.split(',') if f]
    print(f'[card] {run.card_line()}', flush=True)
    _, cfg, traffic, _, _ = run.load_cell(CELL)
    limits = traffic['limits']
    if args.plain_attention:
        from tuch_tpu_torch.models import vit
        from tuch_tpu_torch.ops import attention
        vit.fused_mha = attention.mha_reference
    factor = plant_loss_fault() if faults else None
    ctx = dict(root=ROOT, cell={}, config=cfg, traffic=traffic,
               seed=seeds[0], seconds=0.0, control=False, tmp=None,
               device=DEVICE)
    cell = D.Cell(ctx)
    cell.setup()
    wrapped = reft.eft_loss, reft.Adam
    sides = [(f'program {k + 1}' if args.repeat > 1 else 'program', False,
              1.0) for k in range(args.repeat)]
    sides += [] if args.no_control else [('control', True, 1.0)]
    sides += [(f'loss x {f!r}', False, f) for f in faults]
    worst = {}
    for seed in seeds:
        got = {}
        for side, control, f in sides:
            if factor is not None:
                factor[0] = f
            F.set_precision(cfg, control)
            start = F.seed_model(cell.runtime.hmr, cfg, traffic, seed,
                                 DEVICE)
            cell.first.arm()
            n0 = D.mha_launches()
            r = D.fit_image(cell.fit_one, start, seed, 0, cell.P, cfg,
                            DEVICE)
            got[side] = dict(cell.first.readings(), steps=r.steps,
                             launches=D.mha_launches() - n0)
        if factor is not None:
            factor[0] = 1.0
        F.set_precision(cfg, False)
        ref = D.follow(cfg, traffic, seed, DEVICE)
        # follow's FirstFit wraps tuchref's eft for good: unwrap it, so
        # that no seed's readings outlive it
        reft.eft_loss, reft.Adam = wrapped
        for side, readings in got.items():
            checks = D.compare(readings, ref, limits)
            fails = [c['name'] for c in checks if c['value'] > c['limit']]
            print(f'[{side}] seed {seed}: ' + ', '.join(
                f'{c["name"]} {c["value"]!r}' for c in checks)
                + f'; steps {readings["steps"]} (reference {ref["steps"]});'
                f' kernel-1 launches {readings["launches"]};'
                f' over its limit: {fails or "none"}', flush=True)
            kind = 'program' if side.startswith('program') else side
            w = worst.setdefault(kind, {})
            pick = max if kind == 'program' else min
            for c in checks:
                w[c['name']] = pick(w.get(c['name'], c['value']), c['value'])
    print(f'[spread] {len(seeds)} seeds: '
          + '; '.join(f'{k} {"largest" if k == "program" else "smallest"}'
                      f' {v}' for k, v in worst.items())
          + f'; limits {limits}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
