"""models of the PyTorch port (mirrors tsne_flink_tpu/models)."""
