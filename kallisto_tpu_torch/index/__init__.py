from .build import build_index, TpuIndex  # noqa: F401
from .format import index_from_numpy, load_index, save_index  # noqa: F401
