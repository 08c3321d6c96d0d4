"""adam_ms.fit: host ms per EFT step inside the program's eft_step.adam
spans (eager Adam over HMR's 161 tensors)."""


def read(ctx):
    trace, res = ctx.get('trace'), ctx['result']
    if trace is None or not res.get('steps'):
        return None
    host = sum(s1 - s0 for name, s0, s1 in trace.spans
               if name == 'eft_step.adam')
    return host / 1e3 / sum(res['steps']) if host > 0 else None
