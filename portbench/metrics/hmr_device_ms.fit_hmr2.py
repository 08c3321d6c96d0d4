"""hmr_device_ms.fit_hmr2: device ms per EFT step of the operations
launched under the program's eft_step.forward.hmr spans (and the
.hmr.graph replay inside them), under eft_step.backward.hmr, or under
models/hmr2's own hmr.backbone and hmr.head spans (open on an eager
forward only), in the traced window: HMR 2.0's forward and backward on
the card."""


def _hmr(span):
    return (span.startswith(('eft_step.forward.hmr', 'hmr.'))
            or span == 'eft_step.backward.hmr')


def read(ctx):
    trace, res = ctx.get('trace'), ctx['result']
    if trace is None or not res.get('steps'):
        return None
    ms = sum(e - s for _, s, e, span in trace.kernels
             if _hmr(span) and trace.t0_us <= s <= trace.t1_us) / 1e3
    return ms / sum(res['steps']) if ms > 0 else None
