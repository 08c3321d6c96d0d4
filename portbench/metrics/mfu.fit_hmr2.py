"""mfu.fit_hmr2: the EFT steps' required operations over the window's time
at the float32 peak (TF32 off), in %: HMR 2.0's forward and backward at
B=1 (ViTPose-H's products and attention, the patch convolution without the
image's gradient, the decoder and the three decoders; hmr2_counts), and the
contact kernels' pairs (kernels 2 and 4, as their launches' shapes give
them, as mfu.fit counts them)."""

from portbench import common, hmr2_counts


def read(ctx):
    res, cfg = ctx['result'], ctx['config']
    if not res.get('steps'):
        return None
    counts = res.get('counts', {})
    contact = sum(common.winding_ops(*s) for s in counts.get('winding', []))
    contact += sum(common.masked_min_ops(*s)
                   for s in counts.get('masked_min', []))
    ops = sum(res['steps']) * hmr2_counts.step_flops(cfg) + contact
    peak = common.PEAK_FLOPS['tf32' if cfg['tf32'] else 'float32']
    return 100.0 * ops / peak / res['window_s']
