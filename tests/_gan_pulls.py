"""The reference's two cotangent pulls of the SDE-GAN clip step, written
over the port's public ``gan_losses``: the check that
``launch.steps.sde_gan_grads`` (one pull, the generator's part negated)
gives both players' gradients bitwise."""

import torch

from repro_torch import tree
from repro_torch.core.sde import gan_losses


def two_pull_grads(params, cfg, key, y_real, batch: int):
    """``(gen_loss, disc_loss, gen_grads, disc_grads)`` from one forward and
    two ``torch.autograd.grad`` pulls: ``gen_loss`` over the generator's
    leaves, then ``disc_loss`` over the discriminator's."""
    gen_leaves, gspec = tree.flatten(params["gen"])
    disc_leaves, dspec = tree.flatten(params["disc"])
    gen_leaves = [x.detach().requires_grad_() for x in gen_leaves]
    disc_leaves = [x.detach().requires_grad_() for x in disc_leaves]
    gl, dl, _ = gan_losses({"gen": tree.unflatten(gspec, gen_leaves),
                            "disc": tree.unflatten(dspec, disc_leaves)},
                           cfg, key, y_real, batch, paths=False)
    gg = torch.autograd.grad(gl, gen_leaves, retain_graph=True)
    dg = torch.autograd.grad(dl, disc_leaves)
    return (gl.detach(), dl.detach(), tree.unflatten(gspec, list(gg)),
            tree.unflatten(dspec, list(dg)))
