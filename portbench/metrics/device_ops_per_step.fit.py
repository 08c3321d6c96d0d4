"""device_ops_per_step.fit: device operations per EFT step, counting those
in the traced window whose launch fell under one of the program's
eft_step. spans (the work granularity that fusion lowers; a CUDA graph
does not, since the profiler still lists each of its kernels)."""


def read(ctx):
    trace, res = ctx.get('trace'), ctx['result']
    if trace is None or not res.get('steps'):
        return None
    n = sum(1 for _, s, _, span in trace.kernels
            if span.startswith('eft_step.')
            and trace.t0_us <= s <= trace.t1_us)
    return n / sum(res['steps']) if n else None
