"""Random keys for the sampled paths: the port's counterpart of the
threefry keys ``repro`` threads through its rounds.

Everything that draws takes a *key*, an immutable object with three
methods:

  * ``split(n=2)`` -> a tuple of n child keys;
  * ``uniform(shape, minval, device)`` -> fp32 uniforms in [minval, 1);
  * ``gumbel(shape, dtype, device)`` -> standard Gumbel noise.

``categorical(key, logits)`` draws one index per row of ``logits`` from
softmax(logits) along the last axis, exactly as ``jax.random.categorical``
draws (``replace=True``): the argmax of logits plus Gumbel noise, the first
maximum winning. As with JAX keys, a key feeds one draw or one split, and
the callers split in JAX's order, so a key object that hands out
``jax.random``'s bits (the tests' ``JaxKey``) replays JAX's tokens.

``TorchKey(seed)`` is the port's own key: ``split`` derives the children's
seeds on the host by splitmix64 (no device sync), and every draw comes
from a ``torch.Generator`` on the tensor's device seeded from the key, so
one seed gives one sequence of tokens on one device type at no host round
trip. Its bits are not ``jax.random``'s, and a CUDA generator's are not a
CPU generator's.
"""
from __future__ import annotations

import torch

_MASK = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _splitmix64(state: int) -> int:
    """The splitmix64 output for the 64-bit ``state``."""
    z = state & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


class TorchKey:
    """A key drawing from a ``torch.Generator`` seeded with ``seed``."""

    __slots__ = ("seed",)

    def __init__(self, seed: int = 0):
        self.seed = int(seed) & _MASK

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.seed:#x})"

    def split(self, n: int = 2) -> tuple:
        """n children: the first n outputs of the splitmix64 stream that
        starts at this key's seed."""
        return tuple(type(self)(_splitmix64(self.seed + (i + 1) * _GOLDEN))
                     for i in range(n))

    def _rand(self, shape, dtype, device) -> torch.Tensor:
        """Uniforms in [0, 1) on ``device``."""
        g = torch.Generator(device=device)
        g.manual_seed(self.seed)
        return torch.rand(tuple(shape), generator=g, dtype=dtype, device=device)

    def uniform(self, shape, minval: float = 0.0, device="cpu") -> torch.Tensor:
        u = self._rand(shape, torch.float32, device)
        return torch.clamp_min(u * (1.0 - minval) + minval, minval)

    def gumbel(self, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """-log(-log(u)) with u in [tiny, 1), JAX's low-range Gumbel."""
        u = torch.clamp_min(self._rand(shape, dtype, device),
                            torch.finfo(dtype).tiny)
        return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """int32 draws [...] from softmax(logits [..., V]) along the last axis:
    argmax(logits + Gumbel noise), the first maximum winning."""
    noise = key.gumbel(logits.shape, logits.dtype, logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)
