"""mha_roofline.fit_hmr2: kernel 1's share of its roofline in the traced
window, in %: its least time a launch at the cell's shape (B=1, the
configuration's tokens, heads and head dim, float32; hmr2_counts
.mha_bound_s) times the launches the program's counter counted
(ops/attention.mha_cuda.launches over the window, the driver's
mha_launches) over the device time of the kernel's operations in the
trace. None where the trace holds none of them, or where the counter and
the trace disagree on how many ran."""

from portbench import hmr2_counts

KERNEL = 'mha_fwd_kernel'


def read(ctx):
    trace, res, cfg = ctx.get('trace'), ctx['result'], ctx['config']
    launches = res.get('mha_launches')
    if trace is None or not launches:
        return None
    ops = [(s, e) for name, s, e, _ in trace.kernels
           if KERNEL in name and trace.t0_us <= s <= trace.t1_us]
    if len(ops) != launches:
        return None
    device_s = sum(e - s for s, e in ops) / 1e6
    heads = cfg['num_attention_heads']
    bound = hmr2_counts.mha_bound_s(1, hmr2_counts.tokens(cfg), heads,
                                    cfg['hidden_size'] // heads)
    return 100.0 * bound * launches / device_s
