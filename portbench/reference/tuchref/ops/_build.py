"""The reference builds and launches no kernel: every entry raises."""


def _none(*args, **kwargs):
    raise RuntimeError('the plain reference launches no CUDA kernel')


entry = load = check = build = _none
