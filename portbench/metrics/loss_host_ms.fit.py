"""loss_host_ms.fit: host ms per EFT step inside the program's
eft_step.forward.loss and eft_step.backward.loss spans: the whole EFT
loss, forward and backward (losses/eft); the spans nested in
eft_step.forward.loss are inside it and are not added again."""

SPANS = ('eft_step.forward.loss', 'eft_step.backward.loss')


def read(ctx):
    trace, res = ctx.get('trace'), ctx['result']
    if trace is None or not res.get('steps'):
        return None
    host = sum(s1 - s0 for name, s0, s1 in trace.spans if name in SPANS)
    return host / 1e3 / sum(res['steps']) if host > 0 else None
