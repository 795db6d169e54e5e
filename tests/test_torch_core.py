"""The port's partitions, embeddings and factory held against the JAX
package: the same numpy-seeded inputs go through both.

Tolerances: f32 outputs 1e-5 (gathers are exact; a bag sum may add in
another order); bf16 outputs 3e-2 (``tests/test_kernels.py:12``).  Int8
tables dequantize to f32 and take the f32 bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.serve.quantize import quantize_params as jax_quantize_params
from repro_torch import core as tcore
from repro_torch.convert import params_from_jax

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=3e-2, atol=3e-2),
       "int8": dict(rtol=1e-5, atol=1e-5)}


def _np(x):
    return np.asarray(x.to(torch.float32) if torch.is_tensor(x) else x, np.float32)


# ------------------------------------------------------------------ partitions

FAMILIES = [
    ("naive", lambda m: m.naive_partition(97)),
    ("qr", lambda m: m.qr_partitions(97, 10)),
    ("qr_divisible", lambda m: m.qr_partitions(100, 25)),
    ("mixed_radix", lambda m: m.generalized_qr_partitions(97, (3, 5, 7))),
    ("crt", lambda m: m.crt_partitions(97, (10, 11))),
    ("explicit", lambda m: [m.ExplicitPartition(
        size=97, num_buckets=7, table=np.arange(97) % 7),
        m.ExplicitPartition(size=97, num_buckets=14, table=np.arange(97) // 7)]),
]


@pytest.mark.parametrize("name,build", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_partition_codes_match_reference(name, build):
    jparts, tparts = build(jcore), build(tcore)
    size = jparts[0].size
    assert [(p.size, p.num_buckets) for p in tparts] == \
        [(p.size, p.num_buckets) for p in jparts]
    idx = np.arange(size)
    want = np.asarray(jcore.codes_for(jparts, jnp.asarray(idx)))
    got = tcore.codes_for(tparts, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tcore.is_complementary(tparts, size) == jcore.is_complementary(jparts, size)


def test_partition_helpers_match_reference():
    for size in (1, 2, 17, 100, 101, 1 << 20):
        assert tcore.min_collision_free_m(size) == jcore.min_collision_free_m(size)
    # a non-complementary family is recognised as such by both
    parts = [tcore.RemainderPartition(size=30, num_buckets=5, m=5)]
    assert not tcore.is_complementary(parts)
    with pytest.raises(ValueError, match="coprime"):
        tcore.crt_partitions(30, (4, 6))
    with pytest.raises(ValueError):
        tcore.generalized_qr_partitions(100, (3, 3))


# ------------------------------------------------------------------ embeddings

SPECS = [
    ("full", dict(kind="full")),
    ("hash", dict(kind="hash", num_collisions=4)),
    ("qr_mult", dict(kind="qr", num_collisions=4, op="mult")),
    ("qr_add", dict(kind="qr", num_collisions=4, op="add")),
    ("qr_concat", dict(kind="qr", num_collisions=4, op="concat")),
    ("mixed_radix", dict(kind="mixed_radix", op="mult")),
    ("crt", dict(kind="crt", ms=(23, 24), op="add")),
    ("path", dict(kind="path", num_collisions=4, path_hidden=8)),
]
SIZE, DIM = 500, 8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _modules(spec_kw, mode):
    jdt, tdt = DTYPES["bf16" if mode == "bf16" else "f32"]
    jmod = jcore.make_embedding(SIZE, DIM, jcore.EmbeddingSpec(**spec_kw), jdt)
    tmod = tcore.make_embedding(SIZE, DIM, tcore.EmbeddingSpec(**spec_kw), tdt)
    return jmod, tmod


def _params(jmod, mode, seed):
    jp = jmod.init(jax.random.PRNGKey(seed))
    if mode == "int8":
        jp = jax_quantize_params({"tables": [jp]})["tables"][0]
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# int8 quantizes table leaves; a path-based embedding's MLP bank is not a
# table, so that kind is held in f32 and bf16 only
CASES = [(name, kw, mode) for name, kw in SPECS for mode in ("f32", "bf16", "int8")
         if not (name == "path" and mode == "int8")]


@pytest.mark.parametrize("name,spec_kw,mode", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_apply_and_bag_pool_match_reference(name, spec_kw, mode):
    jmod, tmod = _modules(spec_kw, mode)
    assert type(tmod).__name__ == type(jmod).__name__
    assert tmod.num_params == jmod.num_params and tmod.out_dim == jmod.out_dim
    jp, tp = _params(jmod, mode, seed=3)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, SIZE, size=(4, 6))
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
    mask[-1] = 0.0                                      # an empty bag
    got = tmod.apply(tp, torch.from_numpy(idx))
    want = jmod.apply(jp, jnp.asarray(idx))
    assert got.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                         "int8": torch.float32}[mode]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[mode])
    got = tcore.bag_pool(tmod, tp, torch.from_numpy(idx), torch.from_numpy(mask))
    if name == "path":
        # the reference's bag_pool passes a gather hook that its path-based
        # apply does not take; pool its apply by the same contract instead
        rows = jmod.apply(jp, jnp.asarray(idx))
        want = (rows.astype(jnp.float32) * mask[..., None]).sum(axis=-2).astype(rows.dtype)
    else:
        want = jcore.bag_pool(jmod, jp, jnp.asarray(idx), jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[mode])
    np.testing.assert_array_equal(_np(got)[-1], 0.0)


def test_feature_mode_partition_embeddings_match_reference():
    jmod, tmod = _modules(dict(kind="feature", num_collisions=4), "f32")
    jp, tp = _params(jmod, "f32", seed=5)
    idx = np.arange(0, SIZE, 7)
    got = tmod.partition_embeddings(tp, torch.from_numpy(idx))
    want = jmod.partition_embeddings(jp, jnp.asarray(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_factory_matches_reference():
    for size in (10, 1000, 10 ** 6, 33762577):
        for k in (2, 3, 4):
            assert tcore.factory._balanced_radices(size, k) == \
                jcore.factory._balanced_radices(size, k)
    spec = dict(kind="qr", num_collisions=4, threshold=200)
    for size in (3, 200, 201, 10131227):
        j = jcore.make_embedding(size, 16, jcore.EmbeddingSpec(**spec))
        t = tcore.make_embedding(size, 16, tcore.EmbeddingSpec(**spec))
        assert type(t).__name__ == type(j).__name__ and t.num_params == j.num_params
    with pytest.raises(ValueError):
        tcore.EmbeddingSpec(kind="nope")

    class Plan:      # a memory plan's two hooks: one full table, 32 wide
        def spec_for(self, *a, **k):
            return tcore.EmbeddingSpec(kind="full")

        def dim_for(self, feature):
            return 32
    with pytest.raises(ValueError, match="feature="):
        tcore.make_embedding(100, 16, Plan())
    with pytest.raises(ValueError, match="width 32"):
        tcore.make_embedding(100, 16, Plan(), feature=0)


def test_init_scales_follow_reference():
    """Draws differ between the frameworks, but the bounds do not: uniform
    within ±sqrt(1/|S|), the k-th root of it for each table of a `mult`."""
    gen = torch.Generator().manual_seed(0)
    emb = tcore.qr_embedding(10_000, 16, num_collisions=4, op="mult")
    p = emb.init(gen, device="cpu")
    bound = (1.0 / 10_000) ** 0.25
    for t in p.values():
        assert float(t.abs().max()) <= bound and float(t.abs().max()) > 0.9 * bound
    full = tcore.FullEmbedding(10_000, 16).init(gen, device="cpu")["table"]
    assert float(full.abs().max()) <= 0.01
