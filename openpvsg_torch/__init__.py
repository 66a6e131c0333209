"""openpvsg_torch: the PyTorch + CUDA port of OpenPVSG-TPU for one NVIDIA
H100.

It mirrors the subpackage layout of ``openpvsg_tpu`` so each module's
counterpart is found by its path:

- ``openpvsg_torch.models``  — the Mask2Former VPS segmenter (ResNet, the
  axial or the reference's MSDA pixel encoder, masked-attention decoder),
  panoptic fusion, and the
  relation head (``models.relation``: object encoders, pair proposal, four
  temporal heads, losses, pair and target helpers).
- ``openpvsg_torch.kernels`` — hand-written CUDA kernels for Hopper
  (``csrc/*.cu``) with their plain-PyTorch versions, bound through ctypes.
- ``openpvsg_torch.infer``   — segmenter inference (IPS and VPS), the
  stage-2 IPS and VPS runners and stage 3 (``run_rel_set``).
- ``openpvsg_torch.ops``     — bilinear resize and the sampling primitives
  (``grid_sample``, ``point_sample``, ``ms_deform_attn``, uncertainty-
  sampled points).
- ``openpvsg_torch.train``   — stage-1 segmenter training (Hungarian
  assigner, dense or point-sampled loss, the thing/stuff query split,
  optimizer recipe, trainer) and stage-4 relation-head training, with
  checkpoints of both trainers and the import of mmdet Mask2Former
  checkpoints.
- ``openpvsg_torch.eval``    — stage 3's tube matching, stage 5's R@K /
  mR@K evaluation (proxy and mask-grounded), PQ / VPQ and the MOTS
  tracking metrics.
- ``openpvsg_torch.data``    — RLE codec, stage-boundary files, frame and mask
  loading, palette-mask decoding, the train pipeline, pvsg.json accessors,
  the segmenter and relation datasets, the prefetch loader, the packed
  training cache and the synthetic dataset generator.
- ``openpvsg_torch.tools``   — the CLIs (``python -m
  openpvsg_torch.tools.{make_synthetic_data,pack_train_cache,train,test,
  prepare_query_tube_ips,prepare_query_tube_vps,eval_mots}``).
- ``openpvsg_torch.utils``   — the JSONL metrics logger and the palette.
- ``openpvsg_torch.tracker`` — IPS stage 2's mask tracker (Kalman filter,
  track states, association costs with the reconsdot cost on the device,
  the appearance encoder zoo) and the query-feature tubes.
- ``openpvsg_torch.parallel`` — the multi-device half: a ``(data, time)``
  mesh of local devices with replicated modules, the frame- and pair-
  sharded executors, the time-sharded relation head, and the
  ``torch.distributed`` helpers of the multi-process trainer and CLIs.
- ``openpvsg_torch.native``  — ctypes binding of ``native/pvsg_native.cpp``.

The port imports torch, numpy and scipy only; it never imports jax, flax or
``openpvsg_tpu``. Entry points run on the GPU unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

# Class cardinalities of the PVSG task (reference:
# datasets/datasets/pvsg_image.py:33-39, tools/rel_train.py:58).
NUM_THING_CLASSES = 115
NUM_STUFF_CLASSES = 11
NUM_CLASSES = NUM_THING_CLASSES + NUM_STUFF_CLASSES  # 126
NUM_RELATIONS = 57

# Panoptic id conventions: the mmdet-internal format uses
# segment = label + inst * INSTANCE_OFFSET; the evaluation format uses
# segment = label * EVAL_DIVISOR + inst.
INSTANCE_OFFSET = 1000
EVAL_DIVISOR = 10000
