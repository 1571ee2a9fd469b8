"""Data pipeline: datasets (with geometries for MACE), static-shape
packing, loader, device transfer."""

from .batch import (PackedGraphBatch, PackSpec, empty_batch, pack_graphs,
                    packs_needed, place_graphs, plan_spec, to_device)
from .dataset import ChemDataset
from .geometry import GeometryDataset
from .loader import PackedLoader

__all__ = ["PackedGraphBatch", "PackSpec", "empty_batch", "pack_graphs",
           "packs_needed", "place_graphs", "plan_spec", "to_device",
           "ChemDataset", "GeometryDataset", "PackedLoader"]
