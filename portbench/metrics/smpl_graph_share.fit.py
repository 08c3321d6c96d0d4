"""smpl_graph_share.fit: the share of the traced window's EFT steps whose
SMPL forward was a CUDA graph replay, in %: the program's
eft_step.forward.smpl.graph spans over the steps (models/smpl); None where
there are none (the eager path opens none)."""

SPAN = 'eft_step.forward.smpl.graph'


def read(ctx):
    trace, res = ctx.get('trace'), ctx['result']
    if trace is None or not res.get('steps'):
        return None
    n = sum(1 for name, _, _ in trace.spans if name == SPAN)
    return 100.0 * n / sum(res['steps']) if n else None
