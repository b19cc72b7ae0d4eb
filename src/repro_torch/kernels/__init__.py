"""Hand-written Hopper kernels of the serving paths, their plain PyTorch
versions (``ref``) and the device dispatch (``ops``).

=================  ==============================  =================================
kernel             CUDA source                     replaces (TPU kernel)
=================  ==============================  =================================
rmsnorm            csrc/rmsnorm.cu                 repro/kernels/rmsnorm.py
swiglu             csrc/swiglu.cu                  repro/kernels/swiglu.py
flash_attention    csrc/flash_attention.cu         repro/kernels/flash_attention.py
wkv6               csrc/wkv6.cu                    repro/kernels/rwkv6_scan.py
mamba2_ssd         csrc/mamba2_ssd.cu              repro/kernels/mamba2_scan.py
=================  ==============================  =================================

Each wrapper module holds a :class:`~repro_torch.kernels.build.CudaKernel`
as ``KERNEL``, whose ``launches`` counts the launches it made, and launches
through :func:`~repro_torch.kernels.autograd.kernel_call`, which makes the
launch differentiable through the plain version under grad mode.
"""
from . import flash_attention as _flash_attention_mod
from . import mamba2_ssd as _mamba2_ssd_mod
from . import ops, ref  # noqa: F401
from . import rmsnorm as _rmsnorm_mod
from . import swiglu as _swiglu_mod
from . import wkv6 as _wkv6_mod

#: every kernel of the serving paths, by name
KERNELS = {
    "rmsnorm": _rmsnorm_mod.KERNEL,
    "swiglu": _swiglu_mod.KERNEL,
    "flash_attention": _flash_attention_mod.KERNEL,
    "wkv6": _wkv6_mod.KERNEL,
    "mamba2_ssd": _mamba2_ssd_mod.KERNEL,
}
