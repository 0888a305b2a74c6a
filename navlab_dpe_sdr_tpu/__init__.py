"""navlab_dpe_sdr_tpu — a GPS L1 C/A SDR with Direct Position Estimation,
running in JAX on an NVIDIA GPU.

A from-scratch re-design of the capabilities of Stanford-NavLab/NavLab-DPE-SDR
(PyGNSS + CUDARecv) for an accelerator driven from JAX:

- host-side float64 numpy for time/orbit bookkeeping (libgnss/*),
- JAX/XLA float32 device pipelines for acquisition, tracking correlators and
  DPE manifold scoring (ops/*, models/*),
- jax.sharding mesh scale-out over the position-time grid (parallel/*),
- native C++ runtime pieces for sample streaming and logging (runtime/*).
"""

from . import constants

__version__ = "0.1.0"
