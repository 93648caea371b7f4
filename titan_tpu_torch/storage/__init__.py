from titan_tpu_torch.storage.api import (Entry, EntryList, KCVMutation, KeyColumnValueStore,
                                   KeyColumnValueStoreManager, KeyRangeQuery,
                                   KeySliceQuery, Order, SliceQuery, StoreFeatures,
                                   StoreTransaction, TransactionHandleConfig)

__all__ = ["Entry", "EntryList", "KCVMutation", "KeyColumnValueStore",
           "KeyColumnValueStoreManager", "KeyRangeQuery", "KeySliceQuery",
           "Order", "SliceQuery", "StoreFeatures", "StoreTransaction",
           "TransactionHandleConfig"]
