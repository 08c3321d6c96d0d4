"""hmr_host_ms.fit: host ms per EFT step inside the program's
eft_step.forward.hmr and eft_step.backward.hmr spans: ResNet-50 and the
IEF head, forward and backward (models/hmr)."""

SPANS = ('eft_step.forward.hmr', 'eft_step.backward.hmr')


def read(ctx):
    trace, res = ctx.get('trace'), ctx['result']
    if trace is None or not res.get('steps'):
        return None
    host = sum(s1 - s0 for name, s0, s1 in trace.spans if name in SPANS)
    return host / 1e3 / sum(res['steps']) if host > 0 else None
