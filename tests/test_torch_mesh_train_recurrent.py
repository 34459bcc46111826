"""The mesh training step for the recurrent families (recurrentgemma-2b's
RG-LRU and local attention, xlstm-1.3b's mLSTM and sLSTM) on
``["cpu"] * 4``, against the port's and the reference's unsharded steps:
the bars and the method of ``test_torch_mesh_train.py``, whose checks
this file shares (split off to keep each file's time short)."""
import pytest

from test_torch_mesh_train import check_sharded_step


@pytest.mark.parametrize("nm", [1, 2])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_sharded_step_matches_both_unsharded_steps(arch, shape, nm):
    check_sharded_step(arch, shape, nm)
