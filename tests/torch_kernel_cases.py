"""Seeded inputs for kernel K10 ``meta_any`` shared by the CPU tests
(tests/test_torch_meta_any.py: a numpy model of the kernel's table) and
the card's (tests/test_torch_cuda.py). Imports no JAX: the card's
machine has none."""

from typing import Sequence, Tuple

import numpy as np
import torch

from kyverno_tpu_torch import kernels

# plane slots of ``meta_any_mix``, by source kind: resource-major bank
# planes (contiguous with 16-byte rows, contiguous with 4-byte rows, a
# column slice at an odd offset, a transposed view) and entry-major
# planes (two K9 packs, one of them a row slice, and an unpacked stack)
MIX_SLOTS = [("bank", "a"), ("bank", "b"), ("bank", "c"), ("bank", "d"),
             ("nfa", "a", 0), ("nfa", "a", 1), ("unpacked", "a")]
MIX_SOURCES = {"every": (-1, 0, 1, 2, 3, 4, 5, 6), "hash": (-1,),
               "bank": (0, 1, 2, 3), "pack": (4, 5, 6)}


def meta_any_mix(seed: int, N: int, sizes: Tuple[int, int],
                 sources: Sequence[int], density: float = 0.02,
                 device="cpu") -> Tuple[kernels.MetaAnyTable, list, list,
                                        torch.Tensor, list]:
    """A random namespaces-style K10 case: ``sizes`` entries in the name
    and the namespace family, each drawn from ``sources`` (-1 a literal,
    else a slot of ``MIX_SLOTS``; a third of the plane entries are
    ``self``, duplicates included), with the planes, both hash lanes
    (literals drawn from a small range, so some match), the
    Namespace-kind mask and both non-ASCII masks, on ``device`` (the
    views made there)."""
    rng = np.random.default_rng(seed)
    K = (48, 36, 40, 45)

    def bits(shape, p=density):
        return torch.from_numpy(rng.random(shape) < p).to(device)

    planes = [bits((N, K[0])), bits((N, K[1])),
              bits((N, K[2] + 7))[:, 3:K[2] + 3], bits((K[3], N)).T,
              bits((30, N)), bits((40, N))[5:35], bits((6, N), 0.05)]
    extent = list(K) + [30, 30, 6]
    entry_major = [False] * 4 + [True] * 3
    hashes = [torch.from_numpy(rng.integers(-3, 3, (N, 2)).astype(np.int32))
              .to(device) for _ in range(2)]
    rows, off = [], []
    for f in range(2):
        frows = []
        for _ in range(sizes[f]):
            s = int(rng.choice(sources))
            if s == -1:
                frows.append((-1, int(rng.integers(-3, 3)),
                              int(rng.integers(-3, 3)), 0))
            else:
                frows.append((s, int(rng.integers(0, extent[s])), 0,
                              int(rng.random() < 1 / 3)))
        rows += sorted(frows)
        off.append(len(rows))
    ent = np.asarray(rows, np.int32).reshape(-1, 4)
    table = kernels.MetaAnyTable(("name", "ns"), list(MIX_SLOTS),
                                 entry_major, ent, tuple(off), (True, True),
                                 {"a": ["x", "y", "z", "u", "v", "w"]})
    is_ns = torch.from_numpy(rng.random(N) < 0.3).to(device)
    na = [bits(N, 0.05), bits(N, 0.05)]
    return table, planes, hashes, is_ns, na
