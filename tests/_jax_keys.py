"""``JaxKey``: the port's key protocol (``repro_torch.sampling.keys``)
over ``jax.random``, for the sampled parity tests. ``split`` is
``jax.random.split``, ``uniform`` and ``gumbel`` are ``jax.random``'s
draws handed to torch, so every draw the port makes with a ``JaxKey`` is
the draw JAX makes with the same threefry key, and the port, splitting
where JAX splits, replays JAX's sampled tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


class JaxKey:
    def __init__(self, key):
        self.key = key

    def split(self, n=2):
        return tuple(JaxKey(k) for k in jax.random.split(self.key, n))

    def uniform(self, shape, minval=0.0, device="cpu"):
        u = jax.random.uniform(self.key, tuple(shape), minval=minval)
        return torch.tensor(np.asarray(u), device=device)

    def gumbel(self, shape, dtype=torch.float32, device="cpu"):
        g = jax.random.gumbel(self.key, tuple(shape), _JAX_DTYPE[dtype])
        return torch.tensor(np.asarray(g, np.float32), device=device).to(dtype)
