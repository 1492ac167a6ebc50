"""
Descriptor data model: minimal equivalents of
``smqtk_descriptors.DescriptorElement`` / ``DescriptorSet`` (the UID+vector
unit indexed by every reference implementation, e.g.
/root/reference/smqtk_indexing/impls/nn_index/faiss.py:23-24).

Device-first inversion: ``get_many_vectors`` / ``MemoryDescriptorSet.matrix()``
produce one contiguous float32 matrix in a single pass so the engine can ship
a batch to the device instead of iterating elements (replaces the reference's
host thread/process ``parallel_map`` vector collection).
"""
from __future__ import annotations

import abc
from typing import (
    Any, Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np

from smqtk_indexing_tpu.core.configuration import Configurable
from smqtk_indexing_tpu.core.plugin import Pluggable


class DescriptorElement (Configurable, Pluggable, metaclass=abc.ABCMeta):
    """A UID paired with an optional float descriptor vector."""

    def __init__(self, uuid: Hashable):
        super().__init__()
        self._uuid = uuid

    def uuid(self) -> Hashable:
        return self._uuid

    def __hash__(self) -> int:
        return hash(self._uuid)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, DescriptorElement):
            a, b = self.vector(), other.vector()
            if a is None or b is None:
                return a is None and b is None and self._uuid == other._uuid
            return self._uuid == other._uuid and np.array_equal(a, b)
        return NotImplemented

    def __repr__(self) -> str:
        return f"{type(self).__name__}{{uuid: {self._uuid!r}}}"

    @abc.abstractmethod
    def has_vector(self) -> bool:
        """:return: Whether a vector is currently set."""

    @abc.abstractmethod
    def vector(self) -> Optional[np.ndarray]:
        """:return: The descriptor vector, or None if not set."""

    @abc.abstractmethod
    def set_vector(self, new_vec: Optional[np.ndarray]) -> "DescriptorElement":
        """Set (or clear with None) the descriptor vector. Returns self."""

    @staticmethod
    def get_many_vectors(
        descriptors: Iterable["DescriptorElement"],
    ) -> List[Optional[np.ndarray]]:
        """Batch-collect vectors from many elements (single host pass)."""
        return [d.vector() for d in descriptors]


class DescriptorMemoryElement (DescriptorElement):
    """In-memory descriptor element."""

    def __init__(self, uuid: Hashable,
                 vector: Optional[Sequence] = None):
        super().__init__(uuid)
        self._vector: Optional[np.ndarray] = None
        if vector is not None:
            self.set_vector(np.asarray(vector))

    def get_config(self) -> Dict[str, Any]:
        return {"uuid": self._uuid,
                "vector": self._vector.tolist() if self._vector is not None else None}

    def has_vector(self) -> bool:
        return self._vector is not None

    def vector(self) -> Optional[np.ndarray]:
        return self._vector

    def set_vector(self, new_vec: Optional[np.ndarray]) -> "DescriptorMemoryElement":
        if new_vec is None:
            self._vector = None
        else:
            self._vector = np.asarray(new_vec)
        return self


class DescriptorSet (Configurable, Pluggable, metaclass=abc.ABCMeta):
    """Collection of descriptor elements addressable by UID."""

    def __len__(self) -> int:
        return self.count()

    def __iter__(self) -> Iterator[DescriptorElement]:
        return self.iterdescriptors()

    @abc.abstractmethod
    def count(self) -> int: ...

    @abc.abstractmethod
    def clear(self) -> None: ...

    @abc.abstractmethod
    def has_descriptor(self, uuid: Hashable) -> bool: ...

    @abc.abstractmethod
    def add_descriptor(self, descriptor: DescriptorElement) -> None: ...

    @abc.abstractmethod
    def add_many_descriptors(
        self, descriptors: Iterable[DescriptorElement]) -> None: ...

    @abc.abstractmethod
    def get_descriptor(self, uuid: Hashable) -> DescriptorElement:
        """:raises KeyError: no descriptor for the given UID."""

    @abc.abstractmethod
    def get_many_descriptors(
        self, uuids: Iterable[Hashable]) -> Iterator[DescriptorElement]:
        """:raises KeyError: any UID not present (no partial yield before
            the check completes is required; reference semantics raise on
            first miss)."""

    @abc.abstractmethod
    def remove_descriptor(self, uuid: Hashable) -> None:
        """:raises KeyError: no descriptor for the given UID."""

    @abc.abstractmethod
    def remove_many_descriptors(self, uuids: Iterable[Hashable]) -> None:
        """:raises KeyError: any UID not present; set not modified."""

    @abc.abstractmethod
    def iterkeys(self) -> Iterator[Hashable]: ...

    @abc.abstractmethod
    def iterdescriptors(self) -> Iterator[DescriptorElement]: ...

    def iteritems(self) -> Iterator[Tuple[Hashable, DescriptorElement]]:
        for d in self.iterdescriptors():
            yield d.uuid(), d


class MemoryDescriptorSet (DescriptorSet):
    """
    In-memory descriptor set (dict UID -> element), insertion-ordered.

    ``matrix(uuids)`` extracts a contiguous float32 matrix for device upload.
    """

    def __init__(self) -> None:
        super().__init__()
        self._table: Dict[Hashable, DescriptorElement] = {}

    def get_config(self) -> Dict[str, Any]:
        return {}

    def count(self) -> int:
        return len(self._table)

    def clear(self) -> None:
        self._table.clear()

    def has_descriptor(self, uuid: Hashable) -> bool:
        return uuid in self._table

    def add_descriptor(self, descriptor: DescriptorElement) -> None:
        self._table[descriptor.uuid()] = descriptor

    def add_many_descriptors(
            self, descriptors: Iterable[DescriptorElement]) -> None:
        for d in descriptors:
            self._table[d.uuid()] = d

    def get_descriptor(self, uuid: Hashable) -> DescriptorElement:
        return self._table[uuid]

    def get_many_descriptors(
            self, uuids: Iterable[Hashable]) -> Iterator[DescriptorElement]:
        # Materialize the lookup first so a missing UID raises KeyError
        # before any element is yielded (reference KeyError-non-mutation
        # guarantees depend on this, see
        # /root/reference/smqtk_indexing/impls/nn_index/lsh.py removal flow).
        elems = [self._table[u] for u in uuids]
        return iter(elems)

    def remove_descriptor(self, uuid: Hashable) -> None:
        del self._table[uuid]

    def remove_many_descriptors(self, uuids: Iterable[Hashable]) -> None:
        uuids = list(dict.fromkeys(uuids))  # dedupe: no KeyError mid-delete
        for u in uuids:
            if u not in self._table:
                raise KeyError(u)
        for u in uuids:
            del self._table[u]

    def iterkeys(self) -> Iterator[Hashable]:
        return iter(self._table.keys())

    def iterdescriptors(self) -> Iterator[DescriptorElement]:
        return iter(self._table.values())

    def matrix(self, uuids: Optional[Sequence[Hashable]] = None
               ) -> Tuple[np.ndarray, List[Hashable]]:
        """
        One-pass batched extraction: (float32 matrix of shape (n, d), row->UID
        list). Empty set yields a (0, 0) matrix.
        """
        if uuids is None:
            elems = list(self._table.values())
        else:
            elems = [self._table[u] for u in uuids]
        if not elems:
            return np.zeros((0, 0), dtype=np.float32), []
        mat = np.vstack([e.vector() for e in elems]).astype(np.float32)
        return mat, [e.uuid() for e in elems]
