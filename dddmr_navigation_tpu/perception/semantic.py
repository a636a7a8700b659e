"""Semantic segmentation → class-labeled point clouds — the JAX
re-design of ``dddmr_semantic_segmentation``.

The reference runs a DDRNet23-slim TensorRT engine on CUDA
(`scripts/trt_interface.py:16-80`) and a C++ node that fuses the class
mask with a depth image into per-class point clouds
(`src/semantic_segmentation2point_cloud.cpp:81-176`, intensity = class
id). Here:

  * the network is a compact dual-resolution DDRNet-style flax module —
    a high-resolution detail branch and a strided context branch with
    bilateral fusion, bf16 throughout so the convs run on the matrix
    units.
    (Weights train elsewhere; inference is the deployment surface, as
    with the reference's pre-built .trt engine.)
  * :func:`segmentation_to_pointcloud` reproduces the C++ fusion node:
    depth + class mask + intrinsics → (N, 4) xyz+class cloud.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import flax.linen as nn

from dddmr_navigation_tpu.perception.depth_camera import (
    depth_image_to_points)


class ConvBN(nn.Module):
    features: int
    strides: int = 1
    kernel: int = 3

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(self.features, (self.kernel, self.kernel),
                    strides=(self.strides, self.strides),
                    use_bias=False, dtype=jnp.bfloat16)(x)
        x = nn.GroupNorm(num_groups=8, dtype=jnp.bfloat16)(x)
        return nn.relu(x)


class DDRNetSlim(nn.Module):
    """Dual-resolution segmentation net (DDRNet23-slim shape class):
    detail branch at 1/8, context branch to 1/32, one bilateral fusion,
    upsampled logits. Small enough for realtime on one device."""
    num_classes: int = 19
    width: int = 32

    @nn.compact
    def __call__(self, x):
        w = self.width
        x = x.astype(jnp.bfloat16)
        # stem: 1/4
        x = ConvBN(w, strides=2)(x)
        x = ConvBN(w, strides=2)(x)
        # shared stage: 1/8
        x = ConvBN(2 * w, strides=2)(x)
        detail = ConvBN(2 * w)(x)            # high-res branch stays 1/8
        # context branch: 1/16 → 1/32
        ctx = ConvBN(4 * w, strides=2)(x)
        ctx = ConvBN(4 * w)(ctx)
        ctx = ConvBN(8 * w, strides=2)(ctx)
        # bilateral fusion: context → detail
        up = jax.image.resize(ctx, detail.shape[:1] + detail.shape[1:3]
                              + (ctx.shape[-1],), "bilinear")
        up = ConvBN(2 * w, kernel=1)(up)
        fused = nn.relu(detail + up)
        fused = ConvBN(2 * w)(fused)
        logits = nn.Conv(self.num_classes, (1, 1), dtype=jnp.float32)(fused)
        # back to input resolution
        full = jax.image.resize(
            logits, x.shape[:1] + (x.shape[1] * 8 // 2, x.shape[2] * 8 // 2)
            + (self.num_classes,), "bilinear")
        return full


def init_segmenter(key, height: int = 480, width: int = 640,
                   num_classes: int = 19, net_width: int = 32):
    """Build (module, params) for an RGB (B, H, W, 3) input."""
    model = DDRNetSlim(num_classes=num_classes, width=net_width)
    params = model.init(key, jnp.zeros((1, height, width, 3), jnp.float32))
    return model, params


@partial(jax.jit, static_argnums=(0,))
def infer_classes(model: DDRNetSlim, params, rgb):
    """bf16 forward pass → (B, H, W) class ids (the reference's
    ``np.argmax(output, axis=1)``, `trt_interface.py:70-78`)."""
    logits = model.apply(params, rgb)
    h, w = rgb.shape[1:3]
    logits = jax.image.resize(
        logits, (rgb.shape[0], h, w, logits.shape[-1]), "bilinear")
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def load_class_map_csv(path: str):
    """Ingest the reference's class-map CSVs
    (`data/colors_mapillary*.csv`, `semi-colon `color;description` rows;
    row order = class id, matching `trt_interface.py`'s argmax ids).
    Returns (names list, (C, 3) uint8 color table). Works for both the
    full palette and the display-remap variants
    (colors_mapillary_person_and_sidewalk.csv)."""
    import numpy as np
    names, colors = [], []
    with open(path) as f:
        header = f.readline()
        assert "color" in header and "description" in header, header
        for line in f:
            line = line.strip()
            if not line:
                continue
            color_s, name = line.split(";")
            colors.append([int(t) for t in color_s.split()])
            names.append(name.strip())
    return names, np.asarray(colors, np.uint8)


def colorize_classes(class_mask, color_table):
    """(H, W) class ids → (H, W, 3) uint8 using an ingested class map —
    the reference's mask visualization / display remap."""
    ct = jnp.asarray(color_table)
    return ct[jnp.clip(class_mask, 0, ct.shape[0] - 1)]


def segmentation_to_pointcloud(depth, class_mask, fx, fy, cx, cy,
                               keep_classes=None, depth_scale: float = 1.0):
    """`semantic_segmentation2point_cloud.cpp:81-176`: depth (H, W) +
    class mask (H, W) → (H*W, 4) xyz+class cloud (intensity = class id)
    and a validity mask. ``keep_classes``: optional (C,) class-id array —
    points of other classes are masked out (the reference publishes one
    cloud per configured class)."""
    pts, valid = depth_image_to_points(depth, fx, fy, cx, cy, depth_scale)
    cls = class_mask.reshape(-1).astype(jnp.float32)
    if keep_classes is not None:
        keep = jnp.isin(class_mask.reshape(-1), jnp.asarray(keep_classes))
        valid = valid & keep
    return jnp.concatenate([pts, cls[:, None]], axis=-1), valid


# ---------------------------------------------------------------------------
# weights story: training + checkpointing
# ---------------------------------------------------------------------------
# The reference deploys a PRE-BUILT DDRNet TensorRT engine — its weights
# story is "bring an engine file" (`scripts/trt_interface.py:16-30`). The
# JAX equivalents: (a) fine-tune/train the flax module here (one fused
# jitted step; scale = `jax.pmap`/sharding over the batch axis), and
# (b) serialize/restore params with the runtime checkpoint machinery, the
# analogue of shipping the .trt file.

def softmax_ce_loss(model, params, rgb, labels, ignore_id: int = 255,
                    class_weights=None):
    """Per-pixel cross entropy with an ignore label (the Mapillary/
    Cityscapes convention the reference's class CSVs follow).
    ``class_weights`` (C,) rebalances rare classes (inverse-sqrt
    frequency is the usual choice) — without it, sky/ground dominate a
    19-class street distribution and the rare classes never train."""
    logits = model.apply(params, rgb)
    logits = jax.image.resize(
        logits, rgb.shape[:3] + (logits.shape[-1],), "bilinear")
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    valid = labels != ignore_id
    safe = jnp.where(valid, labels, 0)
    nll = -jnp.take_along_axis(logp, safe[..., None], axis=-1)[..., 0]
    w = valid.astype(jnp.float32)
    if class_weights is not None:
        w = w * jnp.asarray(class_weights, jnp.float32)[safe]
    return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1e-6)


def make_train_step(model, learning_rate=1e-3, class_weights=None):
    """Returns (opt_state_init, jitted step): step(params, opt_state,
    rgb, labels) → (params, opt_state, loss). ``learning_rate`` may be an
    optax schedule."""
    import optax

    tx = optax.adam(learning_rate)

    @jax.jit
    def step(params, opt_state, rgb, labels):
        loss, grads = jax.value_and_grad(
            lambda p: softmax_ce_loss(model, p, rgb, labels,
                                      class_weights=class_weights))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return tx.init, step


def save_params(path: str, params) -> None:
    """Serialize trained weights (the deployment artifact, like the
    reference's .trt engine file)."""
    import numpy as np
    flat, _treedef = jax.tree_util.tree_flatten_with_path(params)
    arrays = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
    np.savez_compressed(path, **arrays)


def load_params(path: str, template_params):
    """Restore weights into a params pytree of the same structure."""
    import numpy as np
    with np.load(path) as data:
        flat, treedef = jax.tree_util.tree_flatten_with_path(template_params)
        leaves = [jnp.asarray(data[jax.tree_util.keystr(k)])
                  for k, _ in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)
