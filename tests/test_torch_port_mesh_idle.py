"""A mesh smaller than the world (ROADMAP C11, repaired).

JAX's ``create_mesh`` takes the first ``data x spatial`` devices and leaves
the rest idle. The port's takes the first ``data x spatial`` ranks of the
process group: a world of 3 ranks over gloo with ``--mesh.data=2`` trains
ranks 0 and 1 exactly as a world of 2 does (losses and every parameter
and buffer bit-equal), and ``tpuseg_torch.main`` returns 0 on rank 2,
which still joined every group creation. No JAX here: the reference is
the world of 2, itself held against JAX in tests/test_torch_port_mesh.py.
"""

from tests import torch_port_mesh_ranks as ranks
from tpuseg_torch.core.mesh import launch_local

ARGV = ["--mesh.data=2", "--model.name=unet", "--model.base_filters=4", "--data.width=32",
        "--data.height=16", "--train.batch_size=4", "--train.epochs=1",
        "--train.steps_per_epoch=2", "--data.val_split=0", "--train.loss=ce+lovasz",
        "--train.checkpoint_dir=", "--train.log_every=0",
        '--data.sources=[{"kind":"synthetic","num_samples":8,"weight":1.0}]']


def test_world_of_three_trains_ranks_0_1_as_a_world_of_two_and_idles_rank_2():
    three = launch_local(ranks.idle_or_trained, 3, timeout_s=240, args=(ARGV,))
    two = launch_local(ranks.idle_or_trained, 2, timeout_s=240, args=(ARGV,))
    assert three[2] == 0
    assert three[:2] == two
    assert two[0]["losses"] == two[1]["losses"] and len(two[0]["losses"]) == 2
    assert two[0]["trained"] == two[1]["trained"]
    assert "data=2, spatial=1" in two[0]["mesh"]
