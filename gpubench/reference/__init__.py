"""The benchmark's plain reference: float32 PyTorch with TF32 off, built
from the SMILES, descriptors, labels, seed and initial weights that the
benchmark hands both sides.  It imports nothing of the program under test,
of ``jax`` or of the JAX package.

* ``chem/``    a frozen copy of the port's featurizer;
* ``pack.py``  a frozen copy of the loader's window plan and best-fit
               placement, which fix the rows of a step and the pack rows
               that the hash dropout is keyed on;
* ``model.py`` the CGR-MPNN forward, the masked SSE and its gradients by
               autograd, the hash dropout and Adam (amsgrad, L2 weight
               decay), with an optional TF32 rounding of every product's
               operands (the control).
"""
