"""The partition mesh's final params after 4 epochs (two of phase 0, two
of phase 1) against the stacked engine's, beside the reference's own
``mode="spmd"`` against ``mode="stacked"`` at the same schedule.

Phase 1 restarts AdamW where the prox term's gradient is 0, so a rounding
difference in phase 0's gradient mean can grow into a params drift; the
reference's tolerance for phase-1 params is 1e-5
(``tests/test_engine_parity.py::test_spmd_shard_map_matches_stacked``).
The reference runs ``shard_map`` over 4 forced host devices in one
subprocess (as ``tests/test_torch_mesh_parity.py`` does); the port runs a
gloo world of 4 ranks on the CPU.  Both at tiny, P = 4, EW, hidden 128,
``max_epochs=4``, ``phase0_fraction=0.5``, for the plain gradient mean and
the bucketed and top-k reducers.

What it showed (here, and at products-s through ``scripts/mesh_drift.py``):
the reference's own drift stays under 1e-5 (0 or a few 1e-9: its psum
over host devices sums in the stacked order), and so must the port's.
The port's bucketed reducer summed each slice with a ``psum`` in gloo's
order and drifted 1.09e-5 at products-s; it now reduce-scatters each
slice (an all_to_all of its P pieces, each rank summing its piece in
partition order) and all-gathers the sums, so it and the top-k reducer
are bitwise the stacked engine, as the reference's are.  The plain mean stays a
``pmean`` (2.85e-6 at products-s)."""
import numpy as np
import pytest

import _torch_mesh_drift_ranks as md

P1_TOL = 1e-5          # the reference's phase-1 params tolerance


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's drifts (subprocess) and the port's world of 4 and
    stacked runs, side by side, at tiny."""
    d = tmp_path_factory.mktemp("drift")
    dst = str(d / "reference.npz")
    ref = md.start_reference(dst, "tiny")
    try:
        mesh, stacked = md.port_runs("tiny", str(d))
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_DONE" in out, err[-3000:]
    return mesh, stacked, dict(np.load(dst))


@pytest.mark.parametrize("name", list(md.RUNS))
def test_reference_drift_stays_under_its_tolerance(runs, name):
    """The reference's own spmd-against-stacked params after 4 epochs:
    under 1e-5, so a port drift past it is the port's."""
    _, _, ref = runs
    assert float(ref[name + "_drift"]) <= P1_TOL, float(ref[name + "_drift"])
    assert float(ref[name + "_loss"]) <= 1e-6


@pytest.mark.parametrize("name", list(md.RUNS))
def test_mesh_4_epoch_params_held_to_the_reference(runs, name):
    """The port's world of 4 after 4 epochs: params within the reference's
    1e-5 of the stacked engine's, the same loss history and phase switch;
    the reducers bitwise the stacked engine, as the reference's are."""
    mesh, stacked, ref = runs
    got, want = mesh[name], stacked[name]
    assert got["engine"] == "spmd" and want["engine"] == "stacked"
    assert got["start"] == want["start"] == 2
    assert float((got["loss"] - want["loss"]).abs().max()) <= 1e-6
    drift = md.drift(got["params"], want["params"])
    assert drift <= P1_TOL, drift
    if name != "sampled":
        assert drift == 0.0 == float(ref[name + "_drift"])
