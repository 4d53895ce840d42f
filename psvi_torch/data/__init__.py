from psvi_torch.data.datasets import (DataBundle, get_regression_benchmark,
                                      hyperparams_for_regression, read_dataset,
                                      read_regression_dataset, split_data)
from psvi_torch.data import synthetic

__all__ = ["read_dataset", "read_regression_dataset", "get_regression_benchmark", "DataBundle",
           "split_data", "hyperparams_for_regression", "synthetic"]
