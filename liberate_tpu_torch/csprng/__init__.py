from .chacha20 import keystream
from .csprng import Csprng
from .discrete_gaussian import build_CDT_binary_search_tree

__all__ = ["Csprng", "keystream", "build_CDT_binary_search_tree"]
