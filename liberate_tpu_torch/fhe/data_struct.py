"""Ciphertext/key container.

``data`` holds int64 word tensors [C, N], tuples of them, or a list of
nested DataStructs (a key-switching key holds one per gadget part).
"""

from ..version import VERSION


class DataStruct:
    """FHE data container (ciphertext, keys, or nested structures).

    Fields:
    - data: int64 tensors [C, N], tuples thereof, or nested DataStructs.
    - include_special: data includes the special-prime channels.
    - ntt_state: data is in the NTT (evaluation) domain.
    - montgomery_state: data is in Montgomery form.
    - origin: type tag (see presets.types.origins).
    - level: current level (0 = freshest).
    - hash: sha256 of the engine's generation parameters.
    - version: serialization version.
    """

    __slots__ = ("data", "include_special", "ntt_state", "montgomery_state",
                 "origin", "level", "hash", "version")

    def __init__(self, data, include_special: bool, ntt_state: bool,
                 montgomery_state: bool, origin: str, level: int,
                 hash: str = "", version: str = VERSION):
        self.data = data
        self.include_special = include_special
        self.ntt_state = ntt_state
        self.montgomery_state = montgomery_state
        self.origin = origin
        self.level = level
        self.hash = hash
        self.version = version

    def _replace(self, **kw) -> "DataStruct":
        fields = {k: getattr(self, k) for k in self.__slots__}
        fields.update(kw)
        return DataStruct(**fields)

    def __iter__(self):
        return iter(getattr(self, k) for k in self.__slots__)

    def __repr__(self):
        return (f"DataStruct(origin={self.origin!r}, level={self.level}, "
                f"ntt={self.ntt_state}, mont={self.montgomery_state}, "
                f"special={self.include_special})")


# Reference-compatible alias.
data_struct = DataStruct
