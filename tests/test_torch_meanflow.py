"""MeanFlow in the port (eo_diffusion_torch.diffusion.meanflow, the dual-time
backbones and the forward-mode rules of the GroupNorm and conv Functions)
against the JAX package, float32 on the CPU.

* the dual-time UNet (FiLM scale-shift, labels with the null row, plain
  attention / JAX "xla") and DiT forwards, weights through weights.py;
* GroupNormFn's ``jvp`` (on the CPU the Function runs its plain versions,
  so the rule runs here) against ``torch.func.jvp`` of the plain GroupNorm
  and against ``jax.jvp`` of the JAX package's ``group_norm_reference``;
  Conv3x3Fn's rule (its forward runs on the CPU when called directly)
  against ``torch.func.jvp`` of ``F.conv2d``;
* ``u`` and ``du/dt`` of one ``torch.func.jvp`` through the UNet; the loss
  and its parameter gradients, CFG-integrated through the UNet and plain
  through the DiT, with the JAX package's draws of (t, r), eps and the
  label dropout injected;
* ``MeanFlow.sample`` trajectories (1-4 steps, label-CFG with the interval,
  the mask composite with the JAX draws, ``start_index``, frames) on a
  closed-form average velocity.

Every JAX result comes from one jitted function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eo_diffusion_torch.diffusion.meanflow import MeanFlow as TMF
from eo_diffusion_torch.models import dit as TD
from eo_diffusion_torch.models import time_template
from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.ops import conv_wgrad as CW
from eo_diffusion_torch.ops import group_norm as TG
from eo_diffusion_torch.weights import dit_state_dict_from_jax_params, state_dict_from_jax_params
from eo_diffusion_tpu.diffusion.meanflow import MeanFlow as JMF
from eo_diffusion_tpu.models import dit as JD
from eo_diffusion_tpu.models import unet as JU
from eo_diffusion_tpu.ops import group_norm as JG
from torch_parity import fill_params, one_torch_thread, rel_err  # noqa: F401

REL_TOL = 1e-5    # forwards, u, du/dt, the loss (f32)
GRAD_TOL = 1e-4   # parameter gradients
TRAJ_TOL = 5e-5   # sampler trajectories
N, SIZE, CLASSES = 2, 8, 3

UNET = dict(image_size=SIZE, in_channels=3, model_channels=16, out_channels=3,
            num_res_blocks=0, attention_resolutions=(1,), channel_mult=(1,), num_heads=2,
            use_scale_shift_norm=True, num_classes=CLASSES, class_dropout_prob=0.1,
            dual_time=True)
DIT = dict(image_size=SIZE, in_channels=3, out_channels=3, patch_size=4, hidden_size=32,
           depth=2, num_heads=2, dual_time=True)
GN_CASES = {"silu": (16, 4, "silu"), "none": (16, 8, "none")}
MF = dict(image_size=SIZE, in_channels=3)
CFG = dict(cfg_omega=2.0, cfg_null_index=CLASSES, cfg_dropout=0.5)
SAMPLE_CASES = {  # num_steps, guidance, inpainting, start_index, log_every
    "1": (1, False, False, None, None),
    "2": (2, False, False, None, None),
    "3_label_cfg_interval": (3, True, False, None, None),
    "4_mask_frames": (4, False, True, None, 2),
    "4_start_index": (4, False, False, 3, None),
}
GUIDE = dict(guidance_scale=2.5, guidance_rescale=0.5, guidance_interval=(0.3, 1.0))


def _init(model, x, t, **kw):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, t, **kw)
    return fill_params(shapes, seed=7)


def _velocity(lib):
    """A closed-form average velocity u(x, (t, r) * 1000, y)."""
    def fn(x, tt, c=None, y=None):
        t, r = tt[:, 0] / 1000.0, tt[:, 1] / 1000.0
        out = 0.6 * x + lib.sin(x) * (t - 0.5 * r)[:, None, None, None] - 0.05
        if y is not None:
            yy = y.astype(jnp.float32) if lib is jnp else y.float()
            out = out + 0.1 * yy[:, None, None, None] * (1.0 + 0.5 * x)
        return out
    return fn


def _data():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    gn = {k: {"x": f(N, 3, 5, c) * 2 + 0.5, "g": 1 + 0.1 * f(N, c), "b": 0.1 * f(N, c),
              "tx": f(N, 3, 5, c), "tg": f(N, c), "tb": f(N, c)}
          for k, (c, _, _) in GN_CASES.items()}
    return {"x0": np.clip(f(N, SIZE, SIZE, 3), -1, 1), "y": np.array([0, 2], np.int32),
            "x": f(N, SIZE, SIZE, 3), "tt": np.array([[700.0, 200.0], [350.0, 350.0]],
                                                     np.float32),
            "gn": gn, "x_T": f(N, SIZE, SIZE, 3), "mask_x0": np.clip(f(N, SIZE, SIZE, 3), -1, 1),
            "mask": (rng.uniform(size=(N, SIZE, SIZE, 1)) > 0.5).astype(np.float32)}


@pytest.fixture(scope="module")
def ref():
    """Everything the JAX package computes, from one jitted function."""
    d = _data()
    ju = JU.UNet(JU.UNetConfig(**UNET, attn_impl="xla"))
    jd = JD.DiT(JD.DiTConfig(**DIT, attn_impl="xla"))
    pu = _init(ju, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 2)), y=jnp.zeros((1,), jnp.int32))
    pd = _init(jd, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 2)))
    key = jax.random.PRNGKey(11)
    mfs = {"plain": JMF.create(**MF), "cfg": JMF.create(**MF, **CFG)}
    mask_rng = jax.random.fold_in(jax.random.PRNGKey(5), 7)
    mask_noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(mask_rng, i),
                                                        (N, SIZE, SIZE, 3)))
                           for i in range(4)])

    def run(pu, pd, d):
        out = {"dit": jd.apply(pd, d["x"], d["tt"])}
        for name, (_, groups, act) in GN_CASES.items():
            g = d["gn"][name]
            f = lambda x, ga, be: JG.group_norm_reference(x, ga, be, groups, act=act)
            out[f"gn_{name}"] = jax.jvp(f, (g["x"], g["g"], g["b"]), (g["tx"], g["tg"], g["tb"]))
        # the CFG-integrated loss through the UNet, the plain one through the DiT
        for name, mf, model, p, y in (("cfg", mfs["cfg"], ju, pu, d["y"]),
                                      ("plain", mfs["plain"], jd, pd, None)):
            tr_rng, n_rng, drop_rng = jax.random.split(key, 3)
            t, r = mf._sample_tr(tr_rng, N)
            eps = jax.random.normal(n_rng, d["x0"].shape, jnp.float32)
            dropped = jax.random.uniform(drop_rng, (N,)) < mf.cfg_dropout
            kw = {} if y is None else {"y": y}
            fn = lambda p: (lambda x, tt, c, yy: model.apply(p, x, tt, **({} if yy is None
                                                                          else {"y": yy})))
            loss, grads = jax.value_and_grad(
                lambda p: mf.train_loss(fn(p), key, d["x0"], y=y, noise=eps))(p)
            out[name] = dict(t=t, r=r, eps=eps, dropped=dropped, loss=loss, grads=grads)
            if name == "cfg":  # u and du/dt through the UNet, the plain tangents
                tb = t[:, None, None, None]
                z = (1 - tb) * d["x0"] + tb * eps
                out[name]["u"], out[name]["dudt"] = jax.jvp(
                    lambda zz, tt, rr: ju.apply(pu, zz, mf.pack_time(tt, rr), **kw),
                    (z, t, r), (eps - d["x0"], jnp.ones_like(t), jnp.zeros_like(r)))
        for name, (steps, guide, mask, start, log_every) in SAMPLE_CASES.items():
            kw = dict(GUIDE, y=d["y"], y_uncond=jnp.full((N,), CLASSES)) if guide else {}
            if mask:
                kw.update(mask=d["mask"], x0=d["mask_x0"])
            res = mfs["plain"].sample(_velocity(jnp), jax.random.PRNGKey(5), N, num_steps=steps,
                                      x_T=d["x_T"], start_index=start, log_every=log_every, **kw)
            out[f"sample_{name}"] = (res.x, res.intermediates)
        return out

    out = jax.tree.map(np.asarray, jax.jit(run)(pu, pd, d))
    return d, pu, pd, out, mask_noise


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _port_unet(pu):
    cfg = TU.UNetConfig(**UNET, attn_impl="plain")
    model = TU.UNet(cfg)
    model.load_state_dict(state_dict_from_jax_params(pu, cfg), strict=True)
    return model, cfg


def _port_dit(pd):
    cfg = TD.DiTConfig(**DIT, attn_impl="plain")
    model = TD.DiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax_params(pd, cfg), strict=True)
    return model, cfg


def _z(d, o):
    t, eps, x0 = _t(o["t"]), _t(o["eps"]), _t(d["x0"])
    return (1 - t[:, None, None, None]) * x0 + t[:, None, None, None] * eps


@pytest.mark.parametrize("backbone", ["unet", "dit"])
def test_dual_time_forward_matches_jax(ref, backbone):
    """The dual-time forwards: the UNet's at the (t, r) of the CFG case (the
    primal of JAX's jvp), the DiT's at two packed pairs."""
    d, pu, pd, out, _ = ref
    if backbone == "unet":
        model, cfg = _port_unet(pu)
        assert {"time_embed_r.0.weight", "time_embed_r.2.bias"} <= set(model.state_dict())
        o, kw = out["cfg"], {"y": _t(d["y"], torch.long)}
        x, tt, want = _z(d, o), torch.stack([_t(o["t"]), _t(o["r"])], -1) * 1000.0, o["u"]
    else:
        model, cfg = _port_dit(pd)
        assert {"r_embed_0.weight", "r_embed_1.bias"} <= set(model.state_dict())
        kw, x, tt, want = {}, _t(d["x"]), _t(d["tt"]), out["dit"]
    with torch.no_grad():
        got = model(x, tt, **kw)
    assert np.abs(want).max() > 0.1
    assert rel_err(got, want) <= REL_TOL
    assert time_template(model, 3).shape == (3, 2) and time_template(cfg).dtype == torch.float32
    with pytest.raises(AssertionError, match="packed"):
        model(x, tt[:, 0], **kw)


@pytest.mark.parametrize("name", sorted(GN_CASES))
def test_group_norm_fn_jvp_matches_plain_and_jax(ref, name):
    """GroupNormFn's forward-mode rule, with tangents on x, gamma and beta
    (FiLM feeds them per sample), against torch.func.jvp of the plain
    GroupNorm and jax.jvp of JAX's group_norm_reference."""
    d, _, _, out, _ = ref
    _, groups, act = GN_CASES[name]
    g = {k: _t(v) for k, v in d["gn"][name].items()}
    fn = lambda x, ga, be: TG.GroupNormFn.apply(x, ga, be, groups, 1e-5, act)[0]
    plain = lambda x, ga, be: TG.group_norm_reference(x, ga, be, groups, 1e-5, act)
    y, dy = torch.func.jvp(fn, (g["x"], g["g"], g["b"]), (g["tx"], g["tg"], g["tb"]))
    yp, dyp = torch.func.jvp(plain, (g["x"], g["g"], g["b"]), (g["tx"], g["tg"], g["tb"]))
    jy, jdy = out[f"gn_{name}"]
    assert rel_err(y, jy) <= REL_TOL and rel_err(dy, jdy) <= REL_TOL
    assert rel_err(dy, dyp.detach().numpy()) <= REL_TOL
    assert torch.equal(y, yp)


def test_conv3x3_fn_jvp_matches_plain():
    """Conv3x3Fn's rule: conv(dx, W) alone when the parameters carry no
    tangent, plus conv(x, dW) + db when they do, against torch.func.jvp of
    F.conv2d."""
    g = torch.Generator().manual_seed(0)
    x, dx = torch.randn(2, 6, 7, 8, generator=g), torch.randn(2, 6, 7, 8, generator=g)
    w, dw = torch.randn(5, 8, 3, 3, generator=g), torch.randn(5, 8, 3, 3, generator=g)
    b, db = torch.randn(5, generator=g), torch.randn(5, generator=g)
    plain = lambda x, w, b: F.conv2d(x.permute(0, 3, 1, 2), w, b, 1, 1).permute(0, 2, 3, 1)
    y, dy = torch.func.jvp(lambda x: CW.Conv3x3Fn.apply(x, w, b, torch.float32, False),
                           (x,), (dx,))
    yp, dyp = torch.func.jvp(lambda x: plain(x, w, b), (x,), (dx,))
    assert torch.equal(y, yp) and rel_err(dy, dyp.numpy()) <= REL_TOL
    _, dy = torch.func.jvp(lambda x, w, b: CW.Conv3x3Fn.apply(x, w, b, torch.float32),
                           (x, w, b), (dx, dw, db))
    _, dyp = torch.func.jvp(plain, (x, w, b), (dx, dw, db))
    assert rel_err(dy, dyp.numpy()) <= REL_TOL
    assert not CW._carries_tangent(w)


def test_meanflow_jvp_matches_jax(ref):
    """u and du/dt of one torch.func.jvp through the UNet (GroupNormFn's rule
    at every norm, FiLM tangents on gamma and beta, the plain attention)."""
    d, pu, _, out, _ = ref
    o = out["cfg"]
    model, _ = _port_unet(pu)
    mf = TMF.create(**MF, **CFG)
    y, t, r = _t(d["y"], torch.long), _t(o["t"]), _t(o["r"])
    u, dudt = torch.func.jvp(lambda zz, tt, rr: model(zz, mf.pack_time(tt, rr), y=y),
                             (_z(d, o), t, r),
                             (_t(o["eps"]) - _t(d["x0"]), torch.ones_like(t), torch.zeros_like(r)))
    assert rel_err(u, o["u"]) <= REL_TOL and rel_err(dudt, o["dudt"]) <= REL_TOL


@pytest.mark.parametrize("name", ["plain", "cfg"])
def test_meanflow_loss_and_gradients_match_jax(ref, name):
    """The loss and every parameter's gradient with JAX's draws injected:
    CFG-integrated (both branches of the target: the label dropout and the
    stop-graded null forward) through the UNet, plain through the DiT."""
    d, pu, pd, out, _ = ref
    o = out[name]
    model, cfg = _port_unet(pu) if name == "cfg" else _port_dit(pd)
    convert = state_dict_from_jax_params if name == "cfg" else dit_state_dict_from_jax_params
    mf = TMF.create(**MF, **(CFG if name == "cfg" else {}))
    y = _t(d["y"], torch.long) if name == "cfg" else None
    fn = lambda x, tt, c, yy: model(x, tt, **({} if yy is None else {"y": yy}))
    loss = mf.train_loss(fn, _t(d["x0"]), y=y, noise=_t(o["eps"]),
                         t=torch.stack([_t(o["t"]), _t(o["r"])], -1), dropped=_t(o["dropped"]))
    loss.backward()
    assert abs(loss.item() - float(o["loss"])) <= REL_TOL * abs(float(o["loss"]))
    want = convert(o["grads"], cfg)
    for k, p in model.named_parameters():
        scale = max(float(want[k].abs().max()), 1e-3)
        assert float((p.grad - want[k]).abs().max()) <= GRAD_TOL * scale, k
    if name == "cfg":
        assert o["dropped"].any() and not o["dropped"].all()


def test_meanflow_draws_itself_and_rejects_other_methods():
    mf = TMF.create(**MF)
    g = torch.Generator().manual_seed(0)
    t, r = mf._sample_tr(4096, g, "cpu")
    assert bool((r <= t).all()) and 0.4 < float((r < t).float().mean()) < 0.6
    fn = lambda x, tt, c, y: 0.5 * x * (tt[:, :1, None, None] / 1000.0)
    loss = mf.train_loss(fn, torch.zeros(2, SIZE, SIZE, 3), generator=g)
    assert loss.ndim == 0 and bool(torch.isfinite(loss))
    with pytest.raises(ValueError, match="euler"):
        mf.sample(fn, 2, device="cpu", method="heun")


@pytest.mark.parametrize("name", sorted(SAMPLE_CASES))
def test_meanflow_sample_matches_jax(ref, name):
    d, _, _, out, mask_noise = ref
    steps, guide, mask, start, log_every = SAMPLE_CASES[name]
    kw = dict(GUIDE, y=_t(d["y"], torch.long),
              y_uncond=torch.full((N,), CLASSES)) if guide else {}
    if mask:
        kw.update(mask=_t(d["mask"]), x0=_t(d["mask_x0"]),
                  noise_fn=lambda i, role: _t(mask_noise[i]))
    res = TMF.create(**MF).sample(_velocity(torch), N, device="cpu", num_steps=steps,
                                  x_T=_t(d["x_T"]), start_index=start, log_every=log_every, **kw)
    x, frames = out[f"sample_{name}"]
    assert rel_err(res.x, x) <= TRAJ_TOL
    if log_every:
        assert res.intermediates.shape == frames.shape
        assert rel_err(res.intermediates, frames) <= TRAJ_TOL
