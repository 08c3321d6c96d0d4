"""contact_host_ms.fit: host ms per EFT step inside the program's
eft_step.forward.loss.neighbors and eft_step.forward.loss.region_pairs
spans: the EFT loss's contact search without gradient (kernels 4 and 2,
the segment forgiving) and its region-pair loop; a part of
loss_host_ms.fit."""

SPANS = ('eft_step.forward.loss.neighbors', 'eft_step.forward.loss.region_pairs')


def read(ctx):
    trace, res = ctx.get('trace'), ctx['result']
    if trace is None or not res.get('steps'):
        return None
    host = sum(s1 - s0 for name, s0, s1 in trace.spans if name in SPANS)
    return host / 1e3 / sum(res['steps']) if host > 0 else None
