from titan_tpu_torch.codec.attributes import Serializer, DEFAULT as DEFAULT_SERIALIZER
from titan_tpu_torch.codec.dataio import DataOutput, ReadBuffer
from titan_tpu_torch.codec.edges import EdgeCodec, RelationCache, TypeInspector

__all__ = ["Serializer", "DEFAULT_SERIALIZER", "DataOutput", "ReadBuffer",
           "EdgeCodec", "RelationCache", "TypeInspector"]
