"""kubernetes_tpu_torch — the scheduler on PyTorch and CUDA.

A port of `kubernetes_tpu` (the JAX package, which stays the reference)
to PyTorch on an NVIDIA H100. Host modules are copies adapted to the port;
the device programs are CUDA kernels written by hand for Hopper
(`csrc/`), each beside a plain PyTorch version of the same function. The
package imports neither `jax` nor `kubernetes_tpu`.

Quantities are int64 end to end, ids int32, masks bool — every tensor's
dtype is written out where it is made (there is no global 64-bit switch
to set, unlike the JAX package).
"""

__version__ = "0.1.0"
