from psvi_torch.data.datasets import DataBundle, read_dataset, read_regression_dataset
from psvi_torch.data import synthetic

__all__ = ["read_dataset", "read_regression_dataset", "DataBundle", "synthetic"]
