"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each family package holds ``ref.py`` (the plain versions, mirroring the
reference's ``ref.py``) and ``ops.py`` (the wrappers).  A wrapper runs the
plain version for a tensor on the CPU and the CUDA kernel for a tensor on
the card; ``cuda.py`` builds and loads the kernels on first use.
"""
import torch


def tenantwise(fn, *args, **kwargs):
    """A plain version over a leading tenant axis: ``fn`` on each tenant's
    slice of every tensor argument (None and host values shared), stacked.
    Each tenant then equals the single call on its operands bit for bit,
    as the kernels promise (a batched CPU matmul may round otherwise)."""
    def at(v, b):
        return v[b] if torch.is_tensor(v) else v

    n = next(a.shape[0] for a in args if torch.is_tensor(a))
    outs = [fn(*(at(a, b) for a in args),
               **{k: at(v, b) for k, v in kwargs.items()}) for b in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)
