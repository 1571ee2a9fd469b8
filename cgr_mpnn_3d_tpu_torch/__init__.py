"""cgr_mpnn_3d_tpu_torch — CGR-MPNN serving and single-device training in
PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``cgr_mpnn_3d_tpu`` (JAX/Pallas), which stays beside it as the
reference.  The module layout mirrors that package so every counterpart is
found at the same path:

* ``chem/``    SMILES parsing and CGR featurization (pure numpy copies);
* ``data/``    the static-shape packer, dataset and (shuffling) loader
               (numpy), plus :func:`data.batch.to_device`;
* ``ops/``     plain-torch gather ops (the oracle), the kernels' elementwise
               helpers (activations, hash dropout) and the whole-model
               kernels (``csrc/``: forward, training step, VJP) with their
               plain versions;
* ``models/``  :class:`models.cgr_mpnn.CGRMPNN`, its ``apply`` and the
               one-launch training step;
* ``train/``   the trainer, checkpoints (the JAX package's ``.npz`` + JSON
               format), metrics, step timing, ``load_model``, ``predict``,
               ``evaluate``;
* ``parallel/`` edge partitioning (``--ep``) with every shard of a step in
               one process: the pack-local EP packer, loader and step;
* ``cli/``     ``train``, ``test`` and ``predict``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (utils/device.py).
"""

__version__ = "0.1.0"
