"""The serving kernels as registered PyTorch operators, namespace ``nmrf``.

``nmrf::window_attention`` (K1), ``nmrf::stripe_attention`` (K2) and
``nmrf::msda_taps`` (B5) are defined here with ``torch.library``; each has

* a CUDA implementation, the kernel's launch function
  (``ops/attention.py:_window_attention_launch``,
  ``_stripe_attention_launch``, ``ops/msda.py:_msda_taps_launch``), which
  counts its launches as the wrapper always did;
* a fake implementation, which gives the output's shape and dtype, so that
  ``torch.export`` traces the forward with fake tensors and records one
  graph node per launch.

There is no CPU implementation: the wrappers send a CPU tensor to the plain
version themselves, and the op called with CPU tensors raises.  An exported
artifact (``utils/export.py``) holds these nodes, so a process that loads
one must first import the modules that register the operators:
:func:`register` does that.
"""

import torch

NAMESPACE = "nmrf"

_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema, cuda, fake):
    """Define ``nmrf::<schema>`` with its CUDA and fake implementations and
    return the operator (``torch.ops.nmrf.<name>.default``)."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def needs_grad(*tensors):
    """Whether autograd records a call on these tensors: the wrappers then
    go through their ``autograd.Function`` (whose forward calls the
    operator), and otherwise (serving, ``torch.no_grad``, an export's
    trace) call the operator directly."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def register():
    """Import the modules that define the ``nmrf`` operators (the kernel
    wrappers of ``ops/attention.py`` and ``ops/msda.py``, not the model)."""
    from . import attention, msda  # noqa: F401
