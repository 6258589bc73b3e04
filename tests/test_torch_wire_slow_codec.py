"""The wire-slow codec (``int8:64``: the activation codec the JAX
package's scheduler grants a client it finds slow on the wire,
``config.yaml``'s ``wire-slow-codec``) and the generic route's other
tiles (``int4:48``, ``int8:100``), through the port's ``QuantCodec``
against the JAX package's, on the CPU.

The same trees, made from a seed with numpy — a VGG cut-7 activation
tree (a bf16 (4, 16, 16, 64) frame and its int32 labels, which pass
through) and its gradient tree (the float32 frame, with an all-zero, a
NaN and an inf tile) — go through each package's ``prepare``, ``encode``
and ``dequantize_leaf``.  The port's codes and scales are held bytewise
against the JAX package's numpy twin (``quantize_np``, which divides in
IEEE float32 as the port does) and against its device codec at the
device chain's tolerance (XLA:CPU divides ``amax`` by ``qmax`` through
its reciprocal, so a scale may sit one ulp off and a code in such a
tile one step off); decoding the same wire leaves is bytewise in both
packages.  ``CodecSpec`` parses each spec as the JAX package's parser
does.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from split_learning_tpu.runtime.codec import quant as jq
from split_learning_tpu.runtime.codec.specs import parse_spec as j_parse
from split_learning_torch.runtime.codec import quant as tq
from split_learning_torch.runtime.codec.specs import parse_spec as t_parse

SPECS = ["int8:64", "int4:48", "int8:100"]
FRAME = (4, 16, 16, 64)


def _trees(seed: int):
    rng = np.random.default_rng(seed)
    act = (rng.standard_normal(FRAME) * 3).astype(ml_dtypes.bfloat16)
    grad = (rng.standard_normal(FRAME) * 1e-3).astype(np.float32)
    flat = grad.reshape(-1)
    flat[:400] = 0.0                  # all-zero tiles at every spec's tile
    flat[1000] = np.nan               # a NaN tile
    flat[3001] = np.inf               # an inf tile
    labels = rng.integers(0, 10, FRAME[0]).astype(np.int32)
    return {"act": (act, labels), "grad": (grad,)}


def _torch_tree(tree):
    def conv(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return tuple(conv(a) for a in tree)


def _bytes(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("spec", SPECS + ["int8", "int4:7"])
def test_spec_parses_as_the_jax_package(spec):
    assert dataclasses.asdict(t_parse(spec)) == dataclasses.asdict(
        j_parse(spec))


@pytest.mark.parametrize("family", ["act", "grad"])
@pytest.mark.parametrize("spec", SPECS)
def test_codec_matches_the_jax_package(spec, family):
    tree = _trees(seed=len(spec) + len(family))[family]
    tcodec = tq.QuantCodec(t_parse(spec), kernels=False)
    jcodec = jq.QuantCodec(j_parse(spec), kernels=False)
    twire = tcodec.encode(tcodec.prepare(_torch_tree(tree)))
    jwire = jcodec.encode(jcodec.prepare(tuple(jnp.asarray(a)
                                               for a in tree)))
    float_leaf = tree[0]
    tl, jl = twire[0], jwire[0]
    assert (tl.bits, tl.tile, tuple(tl.shape)) == (jl.bits, jl.tile,
                                                   tuple(jl.shape))
    # codes and scales: bytewise against the numpy twin
    ref = jq.quantize_np(np.asarray(float_leaf, np.float32), tl.tile,
                         tl.bits)
    assert _bytes(tl.q) == _bytes(ref.q)
    assert _bytes(tl.scale) == _bytes(ref.scale)
    # ... and against the JAX package's device codec at the device
    # chain's tolerance
    a, b = np.asarray(tl.scale), np.asarray(jl.scale)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_max_ulp(a[~np.isnan(a)], b[~np.isnan(b)],
                                    maxulp=1)
    same = a.view(np.uint32) == b.view(np.uint32)

    def codes(q):
        q = np.asarray(q)
        if tl.bits == 8:
            return q.astype(np.int32).reshape(-1, tl.tile)
        u = q.view(np.uint8).astype(np.int32)
        c = np.stack([u & 0xF, u >> 4], axis=-1).reshape(-1)
        return np.where(c < 8, c, c - 16).reshape(-1, tl.tile)
    diff = np.abs(codes(tl.q) - codes(jl.q))
    assert not diff[same].any() and diff.max(initial=0) <= 1
    # non-float leaves pass through unchanged
    for t_leaf, j_leaf in zip(twire[1:], jwire[1:]):
        assert _bytes(t_leaf) == _bytes(j_leaf)
    # decoding the same wire leaf: bytewise in both packages
    for leaf in (tl, jl):
        got = tq.dequantize_leaf(leaf, kernels=False).numpy()
        want = np.asarray(jq.dequantize_leaf(leaf, kernels=False))
        assert got.dtype == np.float32 and got.shape == FRAME
        assert _bytes(got) == _bytes(want)
        assert _bytes(got) == _bytes(jq.dequantize_leaf_np(leaf))
