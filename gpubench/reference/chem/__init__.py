"""A frozen copy of the port's pure-Python featurizer
(``cgr_mpnn_3d_tpu_torch/chem``): SMILES parsing, perception and the CGR
reaction graph.  The benchmark's reference featurizes from the SMILES with
it, so a later change to the program's featurizer cannot move what the
program is compared with."""

from .featurize import GraphArrays, RxnGraph

__all__ = ["GraphArrays", "RxnGraph"]
