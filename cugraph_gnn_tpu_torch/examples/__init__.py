"""Example scripts of the port, each a module with ``main(argv=None)``:

    python -m cugraph_gnn_tpu_torch.examples.ogbn_convert --synthetic N E F --out DIR
    python -m cugraph_gnn_tpu_torch.examples.ogbn_train --dir DIR --epochs 10
    python -m cugraph_gnn_tpu_torch.examples.node_classification --dataset synthetic

Counterparts of the scripts of the same names in the repository's
``examples/``.  The training scripts run on the card unless ``--device cpu``
is passed.
"""
