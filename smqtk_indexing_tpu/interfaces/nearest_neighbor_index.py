"""
Nearest-neighbor index interface.

Contract-parity with
/root/reference/smqtk_indexing/interfaces/nearest_neighbor_index.py:13-184
(template-method validation then dispatch to ``_``-prefixed abstract hooks;
ValueError on empty input iterables / vectorless queries / empty index;
KeyError with no mutation on unknown removal UIDs).

Device-first addition: ``nn_many`` — a batched query entry point so callers can
amortize one device program launch over a whole query matrix, which is where
the matrix-unit throughput comes from. The default implementation loops ``_nn``;
device-backed implementations override ``_nn_many`` with a single batched
kernel and ``_nn`` becomes the batch-of-one special case.
"""
import abc
from typing import Hashable, Iterable, List, Sequence, Tuple

from smqtk_indexing_tpu.core.configuration import Configurable
from smqtk_indexing_tpu.core.plugin import Pluggable
from smqtk_indexing_tpu.data.descriptor import DescriptorElement
from smqtk_indexing_tpu.utils.iter_validation import check_empty_iterable

NNResult = Tuple[Tuple[DescriptorElement, ...], Tuple[float, ...]]


class NearestNeighborsIndex (Configurable, Pluggable):
    """
    Index of descriptor elements supporting k-nearest-neighbor queries.

    Implementations must be thread safe: model state mutation happens behind
    a lock, and (in this framework) on-device state is immutable — a build
    constructs new device arrays and atomically swaps references.

    Persistent storage, when configured, is (over)written whenever
    ``build_index`` is called.
    """

    def __len__(self) -> int:
        return self.count()

    @staticmethod
    def _empty_iterable_exception() -> BaseException:
        """Exception raised for empty build/update/remove input iterables."""
        return ValueError("No DescriptorElement instances in provided "
                          "iterable.")

    def build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        """
        (Re)build the index over the given descriptor elements, replacing any
        existing index state.

        :raises ValueError: The given iterable yielded no elements.
        """
        check_empty_iterable(descriptors, self._build_index,
                             self._empty_iterable_exception())

    def update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        """
        Additively update the index with the given descriptor elements,
        creating a new index if none exists yet.

        :raises ValueError: The given iterable yielded no elements.
        """
        check_empty_iterable(descriptors, self._update_index,
                             self._empty_iterable_exception())

    def remove_from_index(self, uids: Iterable[Hashable]) -> None:
        """
        Remove the descriptors with the given UIDs from the index.

        :raises ValueError: The given iterable yielded no elements.
        :raises KeyError: One or more UIDs are not in the index; the index is
            not modified in that case.
        """
        check_empty_iterable(uids, self._remove_from_index,
                             self._empty_iterable_exception())

    def nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        """
        Return the ``n`` nearest neighbors to descriptor ``d`` with their
        distances (ascending).

        :raises ValueError: ``d`` has no vector set, or the index is empty.
        """
        if not d.has_vector():
            raise ValueError("Query descriptor did not have a vector set!")
        elif not self.count():
            raise ValueError("No index currently set to query from!")
        return self._nn(d, n)

    def nn_many(self, ds: Sequence[DescriptorElement],
                n: int = 1) -> List[NNResult]:
        """
        Batched nearest-neighbor query: one result tuple per input element.

        Device-backed implementations execute this as a single batched kernel
        launch; semantics per element match ``nn``.

        :raises ValueError: Any query missing a vector, or the index is
            empty, or ``ds`` is empty.
        """
        if not ds:
            raise ValueError("No query descriptors provided.")
        for d in ds:
            if not d.has_vector():
                raise ValueError("Query descriptor did not have a vector set!")
        if not self.count():
            raise ValueError("No index currently set to query from!")
        return self._nn_many(ds, n)

    @abc.abstractmethod
    def count(self) -> int:
        """:return: Number of elements currently indexed."""

    @abc.abstractmethod
    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        """Implementation hook for ``build_index`` (input known non-empty)."""

    @abc.abstractmethod
    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        """Implementation hook for ``update_index`` (input known non-empty)."""

    @abc.abstractmethod
    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        """Implementation hook for ``remove_from_index``."""

    @abc.abstractmethod
    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        """Implementation hook for ``nn`` (vector present, index non-empty)."""

    def _nn_many(self, ds: Sequence[DescriptorElement],
                 n: int = 1) -> List[NNResult]:
        """Default batched query: loop the scalar hook."""
        return [self._nn(d, n) for d in ds]
