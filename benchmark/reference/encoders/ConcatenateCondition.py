"""`ConcatenateCondition` over one condition: the condition itself."""


def encode(kwargs, params, x, generator=None):
    return x


def flops(kwargs, frames, rows):
    return 0.0
