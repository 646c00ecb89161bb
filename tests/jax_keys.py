"""A ``jax.random`` key behind the port's key-tree interface
(``fries_tpu_torch.rng``): ``fold``, ``split``, ``uniform`` and ``binomial``
map to ``jax.random.fold_in``, ``jax.random.split``, ``jax.random.uniform``
and ``jax.random.binomial``, and the draws come back as CPU torch tensors.
Fed this tree, the port's pivotal functions, its FCIQMC step and the
frimulti spawner consume the reference's exact draws."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


class JaxKeys:
    def __init__(self, key):
        self.key = key

    def fold(self, i):
        return JaxKeys(jax.random.fold_in(self.key, i))

    def split(self, n):
        return [JaxKeys(k) for k in jax.random.split(self.key, n)]

    def uniform(self, shape=()):
        return torch.as_tensor(np.array(
            jax.random.uniform(self.key, tuple(shape), dtype=jnp.float64)))

    def binomial(self, n, p):
        """Cast as ``fries_tpu.compress.round_binomially`` casts: the trial
        counts and the probabilities to f32."""
        draws = jax.random.binomial(self.key, jnp.asarray(n.cpu().numpy(), jnp.float32),
                                    jnp.asarray(p.cpu().numpy(), jnp.float32))
        return torch.as_tensor(np.array(draws).astype(np.int64))
