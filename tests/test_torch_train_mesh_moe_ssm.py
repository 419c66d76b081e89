"""The port's train step on the mesh (pod, data, model) = (1, 2, 2), 4
gloo processes, against the reference's SPMD step, on the CPU: deepseek-v2-236b and
mamba2-2.7b, reduced (the harness and its limits:
``tests/_train_mesh.py``, ``tests/test_torch_train_mesh.py``).

deepseek-v2-236b's moe layers run expert parallel (E over model, D over
data, the capacity per data shard) and differentiate through the
collectives; each rank routes its tokens with the reference's recorded
choices (every differing choice a near-tie).  mamba2-2.7b is the
reference's third case in ``tests/test_system.py``.
"""
import pytest

from _train_mesh import hold_case, run_cases, tag

CASES = [("deepseek-v2-236b", (1, 2, 2)), ("mamba2-2.7b", (1, 2, 2))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("train_mesh_moe_ssm"), CASES)


@pytest.mark.parametrize("case", CASES, ids=lambda c: tag(*c))
def test_mesh_step_matches_the_reference(runs, case):
    hold_case(runs, *case)


def test_moe_routes_as_the_reference(runs):
    """Every rank routed each moe layer twice (the forward and the remat
    recompute) with the reference's choices, few of them forced."""
    t = tag(*CASES[0])
    for rep in runs["rep"]:
        assert rep[t]["routed"] == 2 * 2
        assert rep[t]["forced"] <= 4


def test_experts_are_held_as_blocks(runs):
    """The experts' blocks on (1, 2, 2): E over model, D over data."""
    from repro_torch.configs import get_arch, reduced
    cfg = reduced(get_arch(CASES[0][0]))
    blocks = runs["rep"][0][tag(*CASES[0])]["blocks"]
    m = cfg.moe
    assert blocks["blocks/moe/w_gate"] == [cfg.n_layers, m.n_experts // 2,
                                           cfg.d_model // 2, m.d_ff_expert]
    assert blocks["blocks/moe/router"] == [cfg.n_layers, cfg.d_model // 2,
                                           m.n_experts]
