"""Packed shading-table tests (passes/shading.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh.lbvh import build_lbvh
from tpurt.passes.shading import (make_shade_table, oct_decode, oct_encode,
                                  pack_rgb, unpack_rgb, shade_from_table)
from tpurt.passes.gbuffer import shade_attributes
from tpurt.scenes import teapot_scene


def test_oct_roundtrip(rng):
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    back = np.asarray(oct_decode(oct_encode(jnp.asarray(n))))
    dots = (back * n).sum(axis=1)
    assert dots.min() > 1.0 - 1e-4  # < ~0.8 degrees of error


def test_rgb_pack_roundtrip(rng):
    a = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    back = np.asarray(unpack_rgb(pack_rgb(jnp.asarray(a))))
    assert np.abs(back - a).max() <= 0.5 / 255 + 1e-6


def test_table_matches_gather_path(rng):
    mesh = teapot_scene(1200)
    bvh = build_lbvh(jnp.asarray(mesh.vertices), jnp.asarray(mesh.indices),
                     leaf_size=4)
    table = make_shade_table(bvh, mesh)
    assert table.shape == (bvh.num_sorted_tris, 24)
    # Lane 16 carries the original triangle id as int32 bits.
    from tpurt.passes.shading import table_tri_id
    tid = np.asarray(table_tri_id(jnp.asarray(table),
                                  jnp.ones(table.shape[0], bool)))
    np.testing.assert_array_equal(tid, np.asarray(bvh.tri_id))
    # Pick random sorted triangles, fabricate hit points inside them, and
    # compare both attribute paths.
    n = 200
    sidx = rng.integers(0, bvh.num_sorted_tris, n).astype(np.int32)
    u = rng.uniform(0.05, 0.45, n).astype(np.float32)
    v = rng.uniform(0.05, 0.45, n).astype(np.float32)
    v0 = np.asarray(bvh.tri_v0)[sidx]
    e1 = np.asarray(bvh.tri_e1)[sidx]
    e2 = np.asarray(bvh.tri_e2)[sidx]
    pos = jnp.asarray(v0 + u[:, None] * e1 + v[:, None] * e2)
    valid = jnp.ones(n, bool)
    tri_id = jnp.asarray(np.asarray(bvh.tri_id)[sidx])
    want = shade_attributes(mesh, tri_id, pos, valid)
    got = shade_from_table(table[jnp.asarray(sidx)], pos, valid)
    np.testing.assert_allclose(np.asarray(got["gnormal"]),
                               np.asarray(want["gnormal"]), atol=1e-5)
    # Smooth normals quantized by octahedral encoding: compare directions.
    dots = np.sum(np.asarray(got["normal"]) * np.asarray(want["normal"]),
                  axis=-1)
    assert dots.min() > 1.0 - 5e-4
    np.testing.assert_allclose(np.asarray(got["albedo"]),
                               np.asarray(want["albedo"]), atol=0.5 / 255 + 1e-6)
