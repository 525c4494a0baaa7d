"""The JAX package's data-parallel steps for tests/test_torch_distributed.py,
run in a subprocess whose ``XLA_FLAGS`` simulate two CPU devices: one
float64 SDE-GAN clip step and one float64 ELBO step under the reference's
``data_parallel_mesh`` (GSPMD shards the batch), at the shapes of
tests/_dp_ranks.py.  Writes the weights, keys, metrics and updated
parameters (numpy) to the pickle named by ``argv[1]``."""

import pickle
import sys

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_threefry_partitionable", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim  # noqa: E402
from repro.core import sde  # noqa: E402
from repro.distributed.compat import set_mesh  # noqa: E402
from repro.distributed.sharding import data_parallel_mesh  # noqa: E402
from repro.launch.steps import (make_gan_optimizers, make_latent_sde_step,  # noqa: E402
                                make_sde_gan_step)

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _dp_ranks import GAN, GAN_BATCH, GAN_SEQ, LATENT, LATENT_BATCH, LATENT_SEQ  # noqa: E402


def main(out_path):
    assert len(jax.devices()) == 2, jax.devices()
    out = {}
    gcfg = sde.NeuralSDEConfig(**GAN, dtype=jnp.float64)
    key = jax.random.PRNGKey(90)
    params = {"gen": sde.generator_init(key, gcfg),
              "disc": sde.discriminator_init(jax.random.fold_in(key, 1), gcfg)}
    (gi, gu), (di, du) = make_gan_optimizers(1.0, "clip")
    mesh = data_parallel_mesh(GAN_BATCH)
    assert mesh is not None
    step_key = jax.random.PRNGKey(91)
    with set_mesh(mesh):
        step = jax.jit(make_sde_gan_step(gcfg, gu, du, GAN_BATCH, GAN_SEQ))
        new, _, _, metrics = step(params, gi(params["gen"]), di(params["disc"]), step_key)
    out["clip"] = jax.device_get((params, np.asarray(step_key), metrics, new))

    lcfg = sde.LatentSDEConfig(**LATENT, dtype=jnp.float64)
    params = sde.latent_sde_init(jax.random.PRNGKey(63), lcfg)
    init, update = optim.adam(1e-2)
    mesh = data_parallel_mesh(LATENT_BATCH)
    step_key = jax.random.PRNGKey(66)
    with set_mesh(mesh):
        step = jax.jit(make_latent_sde_step(lcfg, update, LATENT_BATCH, LATENT_SEQ))
        new, _, metrics = step(params, init(params), step_key)
    out["elbo"] = jax.device_get((params, np.asarray(step_key), metrics, new))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
