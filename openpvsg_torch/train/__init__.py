"""openpvsg_torch.train — stage-1 segmenter training: the Hungarian
assigner, the dense Mask2Former loss, the optimizer recipe, the trainer and
its checkpoints (the counterparts of ``openpvsg_tpu/train/``)."""
