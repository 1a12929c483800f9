"""Helpers for the port's parity tests: one UNet (or DiT) config built in both packages,
with every JAX param leaf overwritten by seeded values and carried into the
port through eo_diffusion_torch.weights.state_dict_from_jax_params.

Every leaf is randomized because ZeroConv/ZeroDense make the fresh output
conv, each ResBlock's out_layers.3 and each attention proj_out exactly zero:
on fresh params the eps prediction would compare as 0 = 0."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eo_diffusion_torch.models import unet as TU
from eo_diffusion_torch.weights import state_dict_from_jax_params
from eo_diffusion_tpu.models import dit as JD
from eo_diffusion_tpu.models import unet as JU


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU ops run several times faster on one thread, and the test
    workers share the machine's cores; import this into a test module to
    use it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    """The same UNet config for the JAX package (f32) and the port (f32)."""
    jcfg = JU.UNetConfig(**kw)
    own = {"dtype", "attn_impl"}  # each package's own values; any other field must exist in both
    tcfg = TU.UNetConfig(**{k: v for k, v in kw.items() if k not in own})
    return jcfg, tcfg


def random_params(jcfg, seed, cond_channels=0):
    """Seeded values (:func:`fill_params`) for every leaf of
    ``JU.UNet(jcfg)``'s param tree."""
    model = JU.UNet(jcfg)
    s = jcfg.image_size
    kw = {}
    if cond_channels:
        kw["cond"] = jnp.zeros((1, s, s, cond_channels))
    if jcfg.num_classes is not None:
        kw["y"] = jnp.zeros((1,), jnp.int32)
    x = jnp.zeros((1, s, s, jcfg.in_channels - cond_channels))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,), jnp.int32), **kw)
    return model, fill_params(shapes, seed)


def random_dit_params(jcfg, seed, cond_channels=0):
    """Seeded values (:func:`fill_params`) for every leaf of
    ``JD.DiT(jcfg)``'s param tree, the zero-initialised adaLN and output
    projections included."""
    model = JD.DiT(jcfg)
    s = jcfg.image_size
    kw = {"cond": jnp.zeros((1, s, s, cond_channels))} if cond_channels else {}
    if jcfg.num_classes is not None:
        kw["y"] = jnp.zeros((1,), jnp.int32)
    x = jnp.zeros((1, s, s, jcfg.in_channels - cond_channels))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x,
                            jnp.zeros((1,), jnp.float32), **kw)
    return model, fill_params(shapes, seed)


def fill_params(shapes, seed):
    """A numpy param tree of ``shapes``' structure: kernels N(0, 1/fan_in),
    embeddings N(0, 1), norm scales 1 + N(0, 0.05^2), biases N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            vals = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            vals = rng.normal(size=shape)
        elif name == "scale":
            vals = 1.0 + 0.05 * rng.normal(size=shape)
        else:
            vals = 0.05 * rng.normal(size=shape)
        return vals.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_model(tcfg, params):
    """The port's UNet loaded (strictly) with the JAX params."""
    model = TU.UNet(tcfg)
    model.load_state_dict(state_dict_from_jax_params(params, tcfg), strict=True)
    return model.eval()


def rel_err(out, ref):
    """max |out - ref| / max |ref|"""
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def trainer_steps(jtr, jstate, ttr, tstate, batches, seed, draw_t):
    """Both trainers take one micro-step per batch from their loaded states.
    The JAX step draws its randomness from ``PRNGKey(seed)``: each step
    takes ``split(_rng)[1]`` (trainer.py:534) and the loss splits once more
    for dropout (:97); ``draw_t(loss_rng)`` recovers the process's t from
    the loss key, which the port takes as ``batch["t"]`` (the noise rides
    the batch on both sides). Returns both trainers' per-step metrics and
    final states (the JAX one as numpy)."""
    key = jax.random.PRNGKey(seed)
    jout, tout = [], []
    for b in batches:
        key, step_rng = jax.random.split(key)
        t = np.asarray(draw_t(jax.random.split(step_rng)[0]))
        jstate, m = jtr.step(jstate, b)
        jout.append({k: float(v) for k, v in m.items()})
        tstate, m = ttr.step(tstate, dict(b, t=t))
        tout.append({k: float(v) for k, v in m.items()})
    return jout, tout, jax.tree.map(np.asarray, jstate), tstate


def rel_l2(tensors, refs):
    """Global relative L2 of torch ``tensors`` against numpy ``refs``."""
    num = sum(float(((a.detach().numpy() - np.asarray(b)) ** 2).sum())
              for a, b in zip(tensors, refs))
    return (num / sum(float((np.asarray(b) ** 2).sum()) for b in refs)) ** 0.5


def closed_form_denoiser(lib):
    """A denoiser ``(x, t, cond, y) -> out`` in closed form, written once for
    jnp and once for torch (``lib``), so that sampler trajectories compile no
    network: smooth in x, varying with t, and moved by the condition and the
    label, so that guidance has two different branches to combine."""
    def fn(x, t, c=None, y=None):
        tt = (t.astype(jnp.float32) if lib is jnp else t.float()) / 1000.0
        out = 0.6 * x + lib.sin(x) * tt[:, None, None, None] - 0.05
        if c is not None:
            out = out + 0.2 * c
        if y is not None:
            yy = y.astype(jnp.float32) if lib is jnp else y.float()
            # a label term that scales with x, so that it moves the std
            out = out + 0.1 * yy[:, None, None, None] * (1.0 + 0.5 * x)
        return out
    return fn


def cached_denoiser(lib, refresh=2):
    """A stateful denoiser in DeepCache's shape, ``(x, t, cond, y, state, i)
    -> (out, state)`` over :func:`closed_form_denoiser`: at every
    ``refresh``-th state index it computes a feature of x and keeps it as the
    state, at the others it reuses the kept one (the state has x's shape,
    doubled under CFG)."""
    base = closed_form_denoiser(lib)

    def fn(x, t, c, y, state, i):
        if lib is jnp:
            feat = jnp.where(i % refresh == 0, jnp.tanh(x), state)
        else:
            feat = torch.tanh(x) if i % refresh == 0 else state
        return base(x, t, c, y) + 0.3 * feat, feat
    return fn
