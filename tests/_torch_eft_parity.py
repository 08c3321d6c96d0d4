"""Set-up shared by the EFT fit tests (not a test module).

The JAX package's fit is one jitted lax.while_loop that splits its key once
a step inside the loop, so its dropout masks cannot be read from its
output. unrolled_jax_fit runs the same steps on the host from the JAX
package's public pieces (the HMR's train apply, smpl_forward, eft_loss,
optax.adam) with fit_one's key splits, and reads each step's keep-masks
from a Flax apply with that step's dropout key (the Dropout outputs'
non-zeros); the tests hold it to make_eft_fit_fn's result and feed its
masks to the port's fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import linen as nn

from tuch_tpu import constants as jconst
from tuch_tpu.losses.eft import EFTWeights, eft_loss
from tuch_tpu.models.smpl import smpl_forward
from tuch_tpu.utils.projection import weak_perspective_to_translation
from tuch_tpu.utils.rotations import rotmat_to_aa


def mask_reader(hmr):
    """read(variables, img, key): the IEF head's keep-masks of a train
    apply with dropout key `key`, in draw_dropout_masks' layout."""

    @jax.jit
    def masks(variables, img, key):
        _, state = hmr.apply(
            variables, img, train=True, rngs={'dropout': key},
            mutable=['batch_stats', 'intermediates'],
            capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
        inter = state['intermediates']
        return [[o != 0 for o in inter[name]['__call__']]
                for name in ('Dropout_0', 'Dropout_1')]

    def read(variables, img, key):
        d1, d2 = masks(variables, img, key)
        return [(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)))
                for a, b in zip(d1, d2)]
    return read


def unrolled_jax_fit(hmr, smpl, assets, img_res, weights=EFTWeights(),
                     lr=1e-5):
    """run(variables, img, kp, contact, key, n_steps): n_steps of the JAX
    fit as fit_one takes them (no early stop), per step a dict of the
    pre-update loss, the pose (1, 72) and betas of its forward, and its
    dropout masks. The step compiles once for every exemplar."""
    opt = optax.adam(lr)
    read = mask_reader(hmr)

    def loss_fn(params, bstats, img, kp, contact, rng):
        (rotmat, betas, cam), new_state = hmr.apply(
            {'params': params, 'batch_stats': bstats}, img, train=True,
            mutable=['batch_stats'], rngs={'dropout': rng})
        out = smpl_forward(smpl, betas, rotmat[:, 1:], rotmat[:, :1],
                           pose2rot=False)
        cam_t = weak_perspective_to_translation(
            cam, jconst.FOCAL_LENGTH, img_res)
        total, _ = eft_loss(out.joints, betas, out.vertices, cam_t, kp,
                            contact, assets, weights, img_res=img_res)
        return total, (new_state['batch_stats'], rotmat, betas)

    @jax.jit
    def step(params, bstats, opt_state, img, kp, contact, rng):
        (loss, (bstats, rotmat, betas)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, bstats, img, kp, contact, rng)
        updates, opt_state = opt.update(grads, opt_state)
        pose = jnp.nan_to_num(rotmat_to_aa(rotmat)).reshape(1, 72)
        return (optax.apply_updates(params, updates), bstats, opt_state,
                loss, pose, betas)

    def run(variables, img, kp, contact, key, n_steps):
        img, kp, contact = (jnp.asarray(x) for x in (img, kp, contact))
        params = variables['params']
        bstats = variables.get('batch_stats', {})
        opt_state = opt.init(params)
        out = []
        for _ in range(n_steps):
            key, sub = jax.random.split(key)
            masks = read({'params': params, 'batch_stats': bstats}, img, sub)
            params, bstats, opt_state, loss, pose, betas = step(
                params, bstats, opt_state, img, kp, contact, sub)
            out.append(dict(loss=float(loss), pose=np.asarray(pose),
                            betas=np.asarray(betas), masks=masks))
        return out
    return run


def fit_inputs(num_classes, img_res, seed=0):
    """One exemplar from a numpy seed: a normalised image (1, H, W, 3),
    keypoints (1, 49, 3) in [-1, 1] with confidences, contact labels."""
    rng = np.random.RandomState(seed)
    img = (rng.randn(1, img_res, img_res, 3) * 0.5).astype(np.float32)
    kp = np.concatenate([rng.uniform(-0.8, 0.8, (1, 49, 2)),
                         rng.uniform(0.2, 1.0, (1, 49, 1))],
                        -1).astype(np.float32)
    contact = (rng.rand(1, num_classes) > 0.5).astype(np.float32)
    return img, kp, contact
