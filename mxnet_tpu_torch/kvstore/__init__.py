"""Key-value stores (counterpart of ``mxnet_tpu/kvstore/``)."""
from .kvstore import (KVStore, KVStoreLocal, KVStoreDevice, KVStoreNCCL, KVStoreDist,
                      create)

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "KVStoreNCCL", "KVStoreDist",
           "create"]
