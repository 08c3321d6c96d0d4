"""smpl_host_ms.fit: host ms per EFT step inside the program's
eft_step.forward.smpl and eft_step.backward.smpl spans: SMPL, forward
and backward (models/smpl)."""

SPANS = ('eft_step.forward.smpl', 'eft_step.backward.smpl')


def read(ctx):
    trace, res = ctx.get('trace'), ctx['result']
    if trace is None or not res.get('steps'):
        return None
    host = sum(s1 - s0 for name, s0, s1 in trace.spans if name in SPANS)
    return host / 1e3 / sum(res['steps']) if host > 0 else None
