from titan_tpu_torch.ids.idmanager import IDManager, IDType, TYPE_BITS, TYPE_MASK

__all__ = ["IDManager", "IDType", "TYPE_BITS", "TYPE_MASK"]
