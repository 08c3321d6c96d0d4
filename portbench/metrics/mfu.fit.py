"""mfu.fit: the EFT steps' required operations, each at the published
peak of the precision it runs in, over the window's time, in %: ResNet-50's
forward and backward at B=1 (convolutions at the float32 peak with TF32
off), the IEF head, and the contact kernels' pairs (kernels 2 and 4, as
their launches' shapes give them)."""

from portbench import common


def read(ctx):
    res, cfg = ctx['result'], ctx['config']
    if not res.get('steps'):
        return None
    px = cfg['img_res']
    conv = 3 * common.resnet50_fwd_flops(px) - common.resnet50_stem_flops(px)
    head = 3 * common.hmr_head_flops(2048)
    conv_peak = common.PEAK_FLOPS['tf32' if cfg['tf32'] else 'float32']
    fp32 = common.PEAK_FLOPS['float32']
    counts = res.get('counts', {})
    contact = sum(common.winding_ops(*s) for s in counts.get('winding', []))
    contact += sum(common.masked_min_ops(*s)
                   for s in counts.get('masked_min', []))
    least = sum(res['steps']) * (conv / conv_peak + head / fp32) \
        + contact / fp32
    return 100.0 * least / res['window_s']
