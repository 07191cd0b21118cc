"""Hand-written kernels and linear maps.

``saga_block`` holds the one kernel the library writes itself: the
coefficient-mode SAGA block step for NVIDIA Hopper GPUs, through Pallas
and Triton. It reads the block's rows once, where the plain XLA step
(``solvers.saga.coeff_block_xla``) reads them twice. ``runtime`` decides
where it runs.
"""

from ciao_tpu.ops.saga_block import block_step_supported, saga_block_step

__all__ = ["block_step_supported", "saga_block_step"]
