"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

``launch_counts`` / ``reset_launch_counts`` read and reset the launch
counters of every kernel wrapper, by kernel name: each module lists its
own counted wrappers in ``COUNTED`` and this package gathers them."""

from typing import Dict

from . import attention, decoder_layer, stack, window_parts

COUNTED = {**decoder_layer.COUNTED, **stack.COUNTED, **attention.COUNTED,
           **window_parts.COUNTED}


def reset_launch_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in COUNTED.items()}
