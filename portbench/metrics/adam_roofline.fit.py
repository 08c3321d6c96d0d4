"""adam_roofline.fit: the program's Adam kernel's share of its bandwidth
roofline in the traced window, in %. Its work is 28 bytes a float32
element (p, g, m and v read once, p', m' and v' written once) times the
elements of a launch, from the program's counters over the run
(ops/adam.adam_cuda.floats over .launches: every step of a cell's fits
runs the same launches) times the trace's launches of the kernel in the
window; its least time that work at 3.35 TB/s; the share that time over
the launches' device time. None where the program has no such kernel or
the trace holds none of its launches."""

KERNEL = 'tuch_adam_kernel'
BYTES_PER_FLOAT = 28
HBM_BYTES_PER_S = 3.35e12


def read(ctx):
    trace = ctx.get('trace')
    if trace is None:
        return None
    try:
        from tuch_tpu_torch.ops.adam import adam_cuda
    except ImportError:
        return None
    if not adam_cuda.launches:
        return None
    ops = [(s, e) for name, s, e, _ in trace.kernels
           if KERNEL in name and trace.t0_us <= s <= trace.t1_us]
    if not ops:
        return None
    device_s = sum(e - s for s, e in ops) / 1e6
    nbytes = BYTES_PER_FLOAT * adam_cuda.floats / adam_cuda.launches \
        * len(ops)
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s
