#!/usr/bin/env python3
"""Export a checkpoint of the JAX package (``openpvsg_tpu``) to one ``.npz``
file that the PyTorch port reads without JAX.

The JAX tools write orbax ``StandardCheckpointer`` directories: the stage-1
trainer's ``epoch_N`` holds its whole ``TrainState`` (``step``, ``params``,
``batch_stats``, ``opt_state``; ``tools/train.py``), the relation trainer's
``epoch_N`` holds ``{"params": ...}`` (``tools/rel_train.py``). This script
restores one and writes its ``params`` (and ``batch_stats``, when present)
as arrays named by their ``/``-joined flax paths (``params/backbone/conv1/
kernel``), beside a ``__header__`` entry: a JSON string naming the format,
the kind (``segmenter`` or ``relation``), the step and the source. The
optimizer's moments are not exported.

    python export_jax_checkpoint.py work_dirs/mask2former_vps/epoch_8 epoch_8.npz
    python export_jax_checkpoint.py work_dirs/relation/.../epoch_100 rel.npz

The port reads the file with ``openpvsg_torch.train.checkpoint
.load_jax_export(path, cfg)``, and its CLIs that take ``--checkpoint``
(``test``, ``prepare_query_tube_vps``, ``prepare_query_tube_ips``,
``end2end_inference``, ``rel_test``, ``rel_test_full``) accept the file in
place of a checkpoint of their own. The writer, ``write_jax_export``, is
the port's (numpy only); this script adds orbax's restore, so it needs JAX
and orbax, and the port's package never imports it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from openpvsg_torch.train.checkpoint import write_jax_export


def restore(path: str) -> dict:
    """The checkpoint directory's tree as nested dicts of host arrays."""
    import jax
    import orbax.checkpoint as ocp

    restored = ocp.StandardCheckpointer().restore(os.path.abspath(path))
    return jax.tree_util.tree_map(np.asarray, restored)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", help="an orbax epoch_N directory of the JAX tools")
    ap.add_argument("out", help="the .npz file to write")
    args = ap.parse_args(argv)
    if not args.out.endswith(".npz"):
        ap.error("the output name must end in .npz")
    header = write_jax_export(restore(args.checkpoint), args.out, source=args.checkpoint)
    print(json.dumps(header))
    return 0


if __name__ == "__main__":
    sys.exit(main())
