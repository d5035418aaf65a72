"""Copy of ``pykmer_tpu/analysis/__init__.py``, held against it
by ``tests/test_torch_copies.py``."""

from .distance import get_matrix, calc_distance, load, read_names_file
from .nj import neighbor_joining
from .cluster import DistanceMatrix, cluster_distance
from . import metrics
