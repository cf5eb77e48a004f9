"""The port's discriminators and GAN losses against the JAX package's, on
the CPU: MPD and MSD scores and feature maps (batched and not; the JAX MSD
on its plain path), every loss of ``losses/gan.py`` with an even-count
median and the TPRLS selection, the discriminator step's parameter
gradients, and the generator side's adversarial loss with its gradient to
the waveform (with and without recomputation).  Narrow towers; tolerance
1e-5 relative in f32 unless noted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.losses import gan as j_gan
from styletts2_tpu.models import discriminators as j_disc
from styletts2_tpu.utils import materialize_params
from styletts2_tpu_torch.config import ModelParams
from styletts2_tpu_torch.losses import gan as t_gan
from styletts2_tpu_torch.models import discriminators as t_disc
from styletts2_tpu_torch.models.zoo import build_nets, flatten, load_jax_params
from styletts2_tpu_torch.train.stage1 import discriminator_step_loss, generator_adversarial_loss

torch.set_num_threads(1)

MPD_CH = (4, 8, 16, 16, 16)
MSD_W = 4
T = 4800        # not a multiple of 7 or 11: those towers reflect-pad


@pytest.fixture(autouse=True, scope="module")
def plain_msd():
    j_disc.set_spec_conv_impl("plain")
    yield
    j_disc.set_spec_conv_impl("auto")


@functools.lru_cache(maxsize=None)
def tiny_discriminators():
    """(JAX {"mpd", "msd"} tree as numpy, the port's nets with it loaded)."""
    tree = materialize_params(jax.eval_shape(lambda k: {
        "mpd": j_disc.init_mpd(jax.random.fold_in(k, 0), MPD_CH),
        "msd": j_disc.init_msd(jax.random.fold_in(k, 1), MSD_W)}, jax.random.PRNGKey(0)),
        seed=5)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    nets = load_jax_params(build_nets(ModelParams(), nets=("mpd", "msd"),
                                      mpd_channels=MPD_CH, msd_width=MSD_W), tree)
    return tree, nets


def waves(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal((b, 1, T))).astype(np.float32) for _ in range(2)]


def close(theirs, ours, rtol=1e-5, atol=1e-6):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=rtol,
                               atol=atol * max(float(np.abs(theirs).max()), 1e-30))


def test_state_dict_keys_and_4d_weights():
    tree, nets = tiny_discriminators()
    for name in ("mpd", "msd"):
        want = {k: np.shape(v) for k, v in flatten(tree[name]).items()}
        assert {k: tuple(v.shape) for k, v in nets[name].state_dict().items()} == want
    assert nets["mpd"].discriminators[0].convs[0].weight_v.shape == (4, 1, 5, 1)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_scores_and_fmaps(which, batched):
    tree, nets = tiny_discriminators()
    y, y_hat = waves(1)
    j_apply = {"mpd": j_disc.mpd_apply, "msd": j_disc.msd_apply}[which]
    t_apply = {"mpd": t_disc.mpd_apply, "msd": t_disc.msd_apply}[which]
    theirs = jax.jit(j_apply, static_argnames="batched")(tree[which], jnp.asarray(y),
                                                         jnp.asarray(y_hat), batched=batched)
    with torch.no_grad():
        ours = t_apply(nets[which], torch.from_numpy(y), torch.from_numpy(y_hat),
                       batched=batched)
    for side in (0, 1):                       # real, fake scores
        assert len(ours[side]) == len(theirs[side]) == (5 if which == "mpd" else 3)
        for a, b in zip(theirs[side], ours[side]):
            close(a, b)
    for side in (2, 3):                       # real, fake fmaps
        for fa, fb in zip(theirs[side], ours[side]):
            assert len(fa) == len(fb) == 6
            for a, b in zip(fa, fb):
                # the JAX MSD's fmaps are NHWC, the port's NCHW
                close(a, b if which == "mpd" else b.permute(0, 2, 3, 1))


@pytest.mark.parametrize("n", [7, 8, 1, 2, 1000])
def test_median_midpoint_and_tprls_selection(n):
    """An even count takes the midpoint of the two middle values, as
    jnp.median; the TPRLS selection ``dr < dg + median(dr - dg)`` picks the
    same elements on both sides."""
    rng = np.random.default_rng(n)
    dr, dg = rng.standard_normal((2, n)).astype(np.float32)
    np.testing.assert_array_equal(float(t_gan.median(torch.from_numpy(dr - dg))),
                                  float(jnp.median(jnp.asarray(dr - dg))))
    if n % 2 == 0 and n > 1:
        s = np.sort(dr - dg)
        assert float(t_gan.median(torch.from_numpy(dr - dg))) != s[n // 2 - 1]
    j_mask = np.asarray(jnp.asarray(dr) < jnp.asarray(dg) + jnp.median(jnp.asarray(dr - dg)))
    t_mask = (torch.from_numpy(dr) < torch.from_numpy(dg)
              + t_gan.median(torch.from_numpy(dr - dg))).numpy()
    np.testing.assert_array_equal(t_mask, j_mask)
    assert 0 < t_mask.sum() < n or n <= 2


def test_losses():
    rng = np.random.default_rng(3)
    shapes = [(2, 12), (2, 7), (2, 30)]
    real = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    fake = [(0.5 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    fm_r = [[rng.standard_normal((2, 3, 5)).astype(np.float32) for _ in range(2)]
            for _ in range(3)]
    fm_g = [[rng.standard_normal((2, 3, 5)).astype(np.float32) for _ in range(2)]
            for _ in range(3)]
    J = lambda xs: jax.tree_util.tree_map(jnp.asarray, xs)            # noqa: E731
    Tt = lambda xs: jax.tree_util.tree_map(torch.from_numpy, xs)      # noqa: E731
    pairs = [
        (j_gan.feature_loss(J(fm_r), J(fm_g)), t_gan.feature_loss(Tt(fm_r), Tt(fm_g))),
        (j_gan.discriminator_loss(J(real), J(fake)), t_gan.discriminator_loss(Tt(real), Tt(fake))),
        (j_gan.generator_loss(J(fake)), t_gan.generator_loss(Tt(fake))),
        (j_gan.discriminator_tprls_loss(J(real), J(fake)), t_gan.tprls_loss(Tt(real), Tt(fake))),
        (j_gan.generator_tprls_loss(J(real), J(fake)), t_gan.tprls_loss(Tt(real), Tt(fake))),
        (j_gan.generator_loss_full((J(real), J(fake), J(fm_r), J(fm_g)),
                                   (J(fake), J(real), J(fm_g), J(fm_r))),
         t_gan.generator_loss_full((Tt(real), Tt(fake), Tt(fm_r), Tt(fm_g)),
                                   (Tt(fake), Tt(real), Tt(fm_g), Tt(fm_r)))),
        (j_gan.discriminator_loss_full((J(real), J(fake), None, None),
                                       (J(fake), J(real), None, None)),
         t_gan.discriminator_loss_full((Tt(real), Tt(fake), None, None),
                                       (Tt(fake), Tt(real), None, None))),
    ]
    for theirs, ours in pairs:
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    # a TPRLS term below TAU (scores close together) stays below it
    near = [r + 0.01 for r in real]
    np.testing.assert_allclose(float(t_gan.tprls_loss(Tt(real), Tt(near))),
                               float(j_gan.discriminator_tprls_loss(J(real), J(near))),
                               rtol=1e-6)


def _check_grads(theirs, ours, tol=1e-4):
    """Each leaf within ``tol`` of its own largest gradient plus the net's
    largest.  1e-4, not 1e-5: a score conv's bias gradient sums ~4e4 terms
    of the score gradient (measured 5.8e-5 of its value), and each package
    sums them in its own order."""
    flat = {k: np.asarray(g) for k, g in flatten(theirs).items()}
    net_max = max(float(np.abs(g).max()) for g in flat.values())
    for k, g in flat.items():
        err = float(np.abs(ours[k].numpy() - g).max())
        assert err <= tol * (float(np.abs(g).max()) + net_max), (k, err)


def test_discriminator_step_gradients():
    """The discriminator step's loss and its MPD/MSD parameter gradients:
    one 2B pass each, the waveforms constants."""
    tree, nets = tiny_discriminators()
    wav, y_rec = waves(2)
    wav = wav[:, 0]

    def j_loss(p):
        y = jnp.asarray(wav)[:, None, :]
        return j_gan.discriminator_loss_full(j_disc.mpd_apply(p["mpd"], y, jnp.asarray(y_rec)),
                                             j_disc.msd_apply(p["msd"], y, jnp.asarray(y_rec)))

    loss, grads = jax.jit(jax.value_and_grad(j_loss))(tree)
    for net in nets.values():
        net.zero_grad()
    ours = discriminator_step_loss(nets["mpd"], nets["msd"], torch.from_numpy(wav),
                                   torch.from_numpy(y_rec))
    ours.backward()
    np.testing.assert_allclose(float(ours), float(loss), rtol=1e-5)
    for name in ("mpd", "msd"):
        _check_grads(grads[name], {k: p.grad for k, p in nets[name].named_parameters()})
        nets[name].zero_grad()


@pytest.mark.parametrize("remat", [True, False])
def test_generator_adversarial_loss_and_input_gradient(remat):
    """The generator side: real and fake in separate passes, the gradient
    to the fake waveform only."""
    tree, nets = tiny_discriminators()
    wav, y_rec = waves(3)
    wav = wav[:, 0]

    def j_loss(yr):
        y = jnp.asarray(wav)[:, None, :]
        return j_gan.generator_loss_full(
            j_disc.mpd_apply(tree["mpd"], y, yr, batched=False),
            j_disc.msd_apply(tree["msd"], y, yr, batched=False))

    loss, g = jax.jit(jax.value_and_grad(j_loss))(jnp.asarray(y_rec))
    y_t = torch.from_numpy(y_rec).requires_grad_()
    for net in nets.values():
        net.requires_grad_(False)
    try:
        ours = generator_adversarial_loss(nets["mpd"], nets["msd"], torch.from_numpy(wav), y_t,
                                          remat=remat)
        ours.backward()
    finally:
        for net in nets.values():
            net.requires_grad_(True)
    np.testing.assert_allclose(float(ours), float(loss), rtol=1e-5)
    g = np.asarray(g)
    err = float(np.abs(y_t.grad.numpy() - g).max())
    assert err <= 1e-5 * float(np.abs(g).max()), err
