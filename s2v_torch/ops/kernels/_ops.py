"""The ``s2v`` operator namespace that K1, K2 and K3 are registered in.

Each kernel is one operator with a CUDA implementation (the launch), a CPU
implementation (its plain PyTorch version) and a fake implementation (the
output's shape and dtype), so ``torch.export`` traces the models through
the operators and an exported program launches the kernels on the card.
Defining the operators builds nothing: that happens at the first launch.
"""

import torch

LIB = torch.library.Library("s2v", "DEF")


def define(schema: str, cuda, cpu, fake):
    """Define ``s2v::<schema>`` with its three implementations; returns the
    operator's default overload, the object the wrappers call."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"s2v::{name}", fake, lib=LIB)
    return getattr(torch.ops.s2v, name).default
