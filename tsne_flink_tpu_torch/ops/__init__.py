"""ops of the PyTorch port (mirrors tsne_flink_tpu/ops)."""
