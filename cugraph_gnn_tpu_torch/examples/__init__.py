"""Example scripts of the port, each a module with ``main(argv=None)`` that
returns a summary dict:

    python -m cugraph_gnn_tpu_torch.examples.ogbn_convert --synthetic N E F --out DIR
    python -m cugraph_gnn_tpu_torch.examples.ogbn_train --dir DIR --epochs 10
    python -m cugraph_gnn_tpu_torch.examples.node_classification --dataset synthetic
    python -m cugraph_gnn_tpu_torch.examples.fraud_detection --num-nodes 4000 --epochs 4
    python -m cugraph_gnn_tpu_torch.examples.cached_embedding_training --epochs 3
    python -m cugraph_gnn_tpu_torch.examples.rgcn_hetero --epochs 10
    python -m cugraph_gnn_tpu_torch.examples.hetero_link_pred --epochs 5 [--disjoint]
    python -m cugraph_gnn_tpu_torch.examples.kg_link_class --epochs 5
    python -m cugraph_gnn_tpu_torch.examples.movielens_rec --epochs 5
    python -m cugraph_gnn_tpu_torch.examples.multichip_training --devices 8
    python -m cugraph_gnn_tpu_torch.examples.hetero_dist_training
    python -m cugraph_gnn_tpu_torch.examples.dist_full_batch_training --devices 8
    python -m cugraph_gnn_tpu_torch.examples.xgb_downstream --num_nodes 2000
    python -m cugraph_gnn_tpu_torch.examples.full_batch_training --model gat
    python -m cugraph_gnn_tpu_torch.examples.link_prediction --epochs 20

Counterparts of the scripts of the same names in the repository's
``examples/``, with their flags and defaults; the training scripts run on
the card unless ``--device cpu`` is passed.  The three distributed scripts
run over the current process group, one process a device (``torchrun``),
or start a world of one.  ``full_batch_training`` and ``link_prediction``
read ``utils.datasets.load_karate``'s file.  ``fraud_detection`` fits
scikit-learn's random forest, or a logistic probe without scikit-learn;
``xgb_downstream`` needs scikit-learn.
"""
