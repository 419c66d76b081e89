"""The port's train step on the mesh (pod, data, model) = (1, 2, 2), 4
gloo processes, against the reference's SPMD step, on the CPU: zamba2-2.7b and
whisper-medium, reduced (the harness and its limits:
``tests/_train_mesh.py``, ``tests/test_torch_train_mesh.py``).

The two families with no mesh test in the reference: the hybrid's shared
block, gathered at each site (its gradient sums over the sites), and the
encoder-decoder, whose frames arrive as this rank's block of the batch.
"""
import pytest

from _train_mesh import hold_case, run_cases, tag

CASES = [("zamba2-2.7b", (1, 2, 2)), ("whisper-medium", (1, 2, 2))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("train_mesh_hybrid_encdec"),
                     CASES)


@pytest.mark.parametrize("case", CASES, ids=lambda c: tag(*c))
def test_mesh_step_matches_the_reference(runs, case):
    hold_case(runs, *case)


def test_the_shared_block_is_held_as_blocks(runs):
    """zamba2's shared attention and MLP are blocks like any leaf: heads
    and ffn over model, embed over data."""
    from repro_torch.configs import get_arch, reduced
    cfg = reduced(get_arch(CASES[0][0]))
    blocks = runs["rep"][0][tag(*CASES[0])]["blocks"]
    assert blocks["shared/mlp/w_up"] == [cfg.d_model // 2, cfg.d_ff // 2]
