"""The port's process mesh and collectives (``parallel/mesh.py``) on four gloo
ranks on the CPU: the groups of a 2 x 2 mesh, the tiled ``all_gather``,
``all_reduce`` and ``ppermute`` against their definitions, the one-call tree
forms, and the world-agreed done check (``world_any``)."""

import numpy as np
import pytest

import torch_ranks

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.spawn(torch_ranks.mesh_body, WORLD, tmp_path_factory.mktemp("mesh"))


def _x(rank):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank


def test_groups_of_a_2x2_mesh(ranks):
    for rank, out in enumerate(ranks):
        pop, nbr = divmod(rank, 2)
        assert out["coords"] == (pop, nbr)
        assert out["pop_members"] == [nbr, 2 + nbr]  # ranks sharing this nbr coordinate
        assert out["nbr_members"] == [2 * pop, 2 * pop + 1]
        assert out["world_members"] == [0, 1, 2, 3]
        assert out["seq_members"] == [0, 1, 2, 3] and out["seq_pop_size"] == 1
        assert out["global_mesh"] == ({"pop": 2, "nbr": 2}, pop, nbr)
        assert out["coordinator"] is (rank == 0)


def test_all_gather_is_tiled_in_axis_order(ranks):
    for rank, out in enumerate(ranks):
        pop, nbr = divmod(rank, 2)
        np.testing.assert_array_equal(out["gather0"], np.concatenate([_x(nbr), _x(2 + nbr)], axis=0))
        np.testing.assert_array_equal(out["gather1"], np.concatenate([_x(2 * pop), _x(2 * pop + 1)], axis=1))
        assert out["gather_bool"] == [True, False, True, False]


def test_all_reduce_sum_max_min(ranks):
    for rank, out in enumerate(ranks):
        pop, nbr = divmod(rank, 2)
        np.testing.assert_array_equal(out["sum"], _x(nbr) + _x(2 + nbr))
        np.testing.assert_array_equal(out["max"], _x(2 * pop + 1))
        np.testing.assert_array_equal(out["min"], _x(0))
        assert out["int64"] == 4 * 2**40 + 6  # exact beyond float precision


def test_ppermute_shifts(ranks):
    for rank, out in enumerate(ranks):
        assert out["shift+1"] == (rank - 1) % WORLD  # member i receives from i - shift
        assert out["shift-1"] == (rank + 1) % WORLD
        pop, nbr = divmod(rank, 2)
        assert out["pop_shift"] == 2 * (1 - pop) + nbr


def test_tree_collectives_keep_dtypes_and_values(ranks):
    for rank, out in enumerate(ranks):
        np.testing.assert_array_equal(out["tree_gather"][0], [[r, -r] for r in range(WORLD)])
        np.testing.assert_array_equal(out["tree_gather"][1], [[0.5 * r] for r in range(WORLD)])
        assert out["tree_gather_dtypes"] == ["torch.int64", "torch.float32"]
        nbr = rank % 2
        np.testing.assert_array_equal(out["tree_sum"][0], [[2 * nbr + 2, -(2 * nbr + 2)]])


def test_done_check_is_world_agreed(ranks):
    for rank, out in enumerate(ranks):
        assert out["any_one"] is True  # rank 3's lane is still running: every rank goes on
        assert out["any_none"] is False
        assert out["any_local"] is (rank == 3)  # without a mesh, the rank's own lanes
