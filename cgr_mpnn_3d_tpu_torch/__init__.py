"""cgr_mpnn_3d_tpu_torch — CGR-MPNN serving and training (one device, data
parallel and edge partitioned, in one process or over the ranks of a gloo
process group) in PyTorch with hand-written CUDA kernels for Hopper
(sm_90a).

A port of ``cgr_mpnn_3d_tpu`` (JAX/Pallas), which stays beside it as the
reference.  The module layout mirrors that package so every counterpart is
found at the same path:

* ``chem/``    SMILES parsing and CGR featurization (pure numpy copies),
               and the RDKit check of the featurizer;
* ``native/``  the C++ featurizer and packer, built with g++ at first use;
* ``data/``    the static-shape packer, dataset, feature cache and
               (shuffling) loader (numpy), the descriptor pipeline, plus
               :func:`data.batch.to_device`;
* ``ops/``     plain-torch gather ops (the oracle), the kernels' elementwise
               helpers (activations, hash dropout) and the whole-model
               kernels (``csrc/``: forward, training step, VJP) with their
               plain versions;
* ``models/``  :class:`models.cgr_mpnn.CGRMPNN`, its ``apply`` and the
               one-launch training step;
* ``train/``   the trainer, checkpoints (the JAX package's ``.npz`` + JSON
               format), metrics, tracing and step timing, ``load_model``,
               ``predict``, ``evaluate``;
* ``parallel/`` data parallelism (``--dp``), edge partitioning (``--ep``:
               the pack-local packer, loader and step; the flat layout's
               ``shard_edges``, forward, steps and ``EPLoader``) and the
               ranks of a multi-process launch;
* ``cli/``     ``train``, ``test``, ``predict``, ``sweep``, ``runbook`` and
               ``bench_ops``; ``python -m cgr_mpnn_3d_tpu_torch`` lists
               them.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (utils/device.py).
"""

__version__ = "0.1.0"
