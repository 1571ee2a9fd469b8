"""cgr_mpnn_3d_tpu_torch — the CGR-MPNN serving path in PyTorch with a
hand-written CUDA kernel for Hopper (sm_90a).

A port of ``cgr_mpnn_3d_tpu`` (JAX/Pallas), which stays beside it as the
reference.  The module layout mirrors that package so every counterpart is
found at the same path:

* ``chem/``    SMILES parsing and CGR featurization (pure numpy copies);
* ``data/``    the static-shape packer, dataset and loader (numpy), plus
               :func:`data.batch.to_device`;
* ``ops/``     plain-torch gather ops (the oracle), the activation helpers
               and the whole-model forward kernel (``csrc/``) with its
               plain version;
* ``models/``  :class:`models.cgr_mpnn.CGRMPNN` and its ``apply``;
* ``train/``   checkpoints (the JAX package's ``.npz`` + JSON format),
               ``load_model``, ``predict``, ``evaluate``;
* ``cli/``     ``predict``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (utils/device.py).
"""

__version__ = "0.1.0"
