"""Heterogeneous distributed training over the ranks of a process group.

Counterpart of ``examples/hetero_dist_training.py`` (the reference's
``taobao_mnmg.py``): hashed user and item ids renumbered, clicks and their
reverse in a ``GraphStore``, per-type features and the items' labels in a
``FeatureStore``, a typed ``DistNeighborLoader`` over the items and the
example's ``TypedSAGE``, 8 epochs through ``train_dist.dist_train_step``
(``train_hetero_dist.train``).  Prints

    first loss A -> last B

checks that the loss fell, and prints ``OK``.  It runs over every rank of
the current process group, one process a device, or starts a world of one.

    python -m cugraph_gnn_tpu_torch.examples.hetero_dist_training

Runs on the card (NCCL) unless ``--device cpu`` is passed (gloo).  ``main``
returns the losses.
"""

import argparse

from cugraph_gnn_tpu_torch.examples.common import example_mesh
from cugraph_gnn_tpu_torch.train_hetero_dist import train


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cpu to run without a card")
    args = p.parse_args(argv)
    with example_mesh(device=args.device) as mesh:
        losses = train(mesh)
        if mesh.rank == 0:
            print(f"first loss {losses[0]:.3f} -> last {losses[-1]:.3f}", flush=True)
        assert losses[-1] < losses[0]
        if mesh.rank == 0:
            print("OK", flush=True)
        return {"losses": losses, "world": mesh.world}


if __name__ == "__main__":
    main()
