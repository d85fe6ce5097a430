"""The kernels as ``torch.library`` custom operators.

Each hand-written kernel's entry point is one operator in the ``m3asr``
namespace, so that ``torch.export`` traces through it (the per-bucket
programs of ``Engine.export_bucket``) and a loaded program calls it
again. An operator has three implementations:

* ``cuda``: the wrapper's launch, with its checks (the kernel builds at
  its first launch, never here);
* ``cpu``: the kernel's plain PyTorch version;
* a fake one (``register_fake``) that gives the output shapes and dtypes
  from the input shapes alone.

None mutates or aliases an input. Registration happens when a wrapper's
module is imported; :data:`OPS` lists the operators in the order they
were registered.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

NAMESPACE = "m3asr"
OPS: Dict[str, object] = {}


def kernel_op(name: str, schema: str, cpu: Callable, cuda: Callable,
              fake: Callable):
    """Register ``m3asr::name`` with ``schema`` (its argument list and
    return, e.g. ``"(Tensor x) -> Tensor"``) and its CPU, CUDA and fake
    implementations. Returns the operator (callable like a function)."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    OPS[name] = op
    return op
