"""Index subsystem: composite indexes in the graphindex store + the mixed
(external provider) index SPI.

(reference: titan-core graphdb/database/IndexSerializer.java — composite key
codec + mixed document mapping; diskstorage/indexing/ — IndexProvider SPI.)
"""

from titan_tpu_torch.indexing.serializer import IndexSerializer, IndexUpdate
from titan_tpu_torch.indexing.provider import (IndexProvider, IndexTransaction,
                                               KeyInformation, IndexQuery,
                                               FieldCondition, And, Or, Not)
from titan_tpu_torch.indexing.memindex import MemoryIndex

__all__ = ["IndexSerializer", "IndexUpdate", "IndexProvider",
           "IndexTransaction", "KeyInformation", "IndexQuery",
           "FieldCondition", "And", "Or", "Not", "MemoryIndex"]
