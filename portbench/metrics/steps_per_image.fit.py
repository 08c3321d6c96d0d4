"""steps_per_image.fit: the mean EFTFitResult.steps of the window's
images (the stop rule's work per image)."""


def read(ctx):
    steps = ctx['result'].get('steps')
    return sum(steps) / len(steps) if steps else None
