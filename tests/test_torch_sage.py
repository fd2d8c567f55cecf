"""GraphSAGE port: the init is bitwise the reference's, weights carry across
with params_from_numpy, and the full-graph forward agrees with the
reference's apply_full on both aggregation backends."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import make_benchmark as j_make_benchmark
from repro_torch.graph import GraphSAGE

# f32 sums in another order than XLA's segment_sum / the Pallas matmul
ATOL, RTOL = 5e-6, 1e-5


@pytest.mark.parametrize("dims,layers,seed", [
    ((16, 16, 5), 2, 0), ((64, 128, 24), 2, 0), ((64, 128, 24), 2, 7),
    ((16, 32, 5), 3, 1), ((8, 8, 3), 1, 2)])
def test_init_bitwise(dims, layers, seed):
    f, h, c = dims
    jp = JGraphSAGE(feature_dim=f, hidden_dim=h, num_classes=c,
                    num_layers=layers).init(seed)
    m = GraphSAGE(f, h, c, num_layers=layers).init(seed)
    assert len(m.layers) == len(jp.layers) == layers
    for lp, jl in zip(m.layers, jp.layers):
        for name in ("w_self", "w_neigh", "b"):
            got = getattr(lp, name).detach().numpy()
            want = np.asarray(getattr(jl, name))
            assert got.dtype == want.dtype and got.shape == want.shape
            assert (got == want).all(), name


def test_layer_dims_match_reference():
    jm = JGraphSAGE(feature_dim=16, hidden_dim=32, num_classes=5, num_layers=3)
    m = GraphSAGE(16, 32, 5, num_layers=3)
    assert m.layer_dims == jm.layer_dims
    assert m.layer_input_dims == jm.layer_input_dims
    with pytest.raises(ValueError):
        GraphSAGE(16, 32, 5, num_layers=0)


def test_params_from_numpy_round_trip():
    rng = np.random.default_rng(4)
    jm = JGraphSAGE(feature_dim=16, hidden_dim=16, num_classes=5)
    jp = jm.init(3)
    # perturb so the load is distinguishable from a fresh init
    layers = [type(l)(*(np.asarray(a) + rng.normal(0, 1, np.shape(a))
                        .astype(np.float32) for a in l)) for l in jp.layers]
    m = GraphSAGE(16, 16, 5).init(0).params_from_numpy(layers)
    for lp, jl in zip(m.layers, layers):
        for name in ("w_self", "w_neigh", "b"):
            assert (getattr(lp, name).detach().numpy()
                    == np.asarray(getattr(jl, name))).all()
    with pytest.raises(ValueError):
        GraphSAGE(16, 16, 5, num_layers=3).params_from_numpy(layers)
    with pytest.raises(ValueError):
        GraphSAGE(16, 8, 5).params_from_numpy(layers)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("j_use_pallas", [True, False])
def test_apply_full_matches_reference(use_kernel, j_use_pallas):
    g = j_make_benchmark(J_BENCHMARKS["tiny"])
    src = np.asarray(g.indices, np.int64)
    dst = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=16,
                    num_classes=g.num_classes)
    want = np.asarray(jm.apply_full(
        jm.init(0), jnp.asarray(g.features), jnp.asarray(src),
        jnp.asarray(dst), g.num_nodes, use_pallas=j_use_pallas,
        interpret=True))
    m = GraphSAGE(g.feature_dim, 16, g.num_classes).init(0)
    with torch.no_grad():
        got = m.apply_full(torch.as_tensor(g.features), torch.as_tensor(src),
                           torch.as_tensor(dst), g.num_nodes,
                           use_kernel=use_kernel).numpy()
    assert got.shape == (g.num_nodes, g.num_classes)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
