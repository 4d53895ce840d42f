"""Results-dict protocol and persistence.

Counterpart of ``psvi_tpu/utils/results.py`` (schema of the reference's
``psvi_classes.py:1009-1027``): keys ``accs, nlls, csizes, times, elbos,
went, ness, vent, vs, us, zs, grid_preds, alpha, avg_epoch_time,
gpu_memory, chosen_indices``, nested as results[dataset][method]
[coreset_size][trial]. Persistence: ``{fnm}.json`` (lists) and ``{fnm}.pk``
(the dict itself) in a folder, timestamped by ``get_save_foldername``.

A pickle written by the JAX package holds numpy arrays, Python scalars and
dicts; its nested ``defaultdict``s name their factory by the JAX package's
import path. ``load_results`` maps those factories onto this module's
``recursive_dict``, so such a file loads here without importing the JAX
package.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import pickle
from typing import Any, Dict

import numpy as np

# the JAX package's recursive defaultdict factories, by import path
_JAX_FACTORIES = {("psvi_tpu.utils.results", "recursive_dict"),
                  ("psvi_tpu.experiments", "rec_dd")}


def recursive_dict():
    # a module-level factory, so that the dicts pickle (a local closure
    # as default_factory does not)
    return collections.defaultdict(recursive_dict)


def _to_jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if hasattr(obj, "tolist"):  # numpy arrays and scalars, tensors
        return obj.tolist()
    return obj


def get_save_foldername(results_folder, data_list, method_list, selection_method="random"):
    """Timestamped results directory (ref experiments_utils.py:851-861)."""
    new_methods = [
        f"{m}_{selection_method}" if m == "mfvi_selection" else m
        for m in method_list
    ]
    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    return os.path.join(
        results_folder, f"{'_'.join(new_methods)}_{'_'.join(data_list)}_{stamp}"
    )


def save_results(results: Dict[str, Any], folder: str, config: Dict[str, Any] = None,
                 fnm: str = "results"):
    """Persist a results dict as ``{fnm}.json`` + ``{fnm}.pk`` (+config.json);
    ``fnm`` is the reference's ``--fnm`` results-filename flag
    (``psvi_experiments.py:55``)."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, f"{fnm}.json"), "w") as f:
        json.dump(_to_jsonable(results), f)
    with open(os.path.join(folder, f"{fnm}.pk"), "wb") as f:
        pickle.dump(results, f)
    if config is not None:
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump(_to_jsonable(config), f, default=str)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _JAX_FACTORIES:
            return recursive_dict
        return super().find_class(module, name)


def load_results(folder: str, fnm: str = "results"):
    """The results dict saved by ``save_results`` (here or by the JAX
    package) in ``folder``."""
    with open(os.path.join(folder, f"{fnm}.pk"), "rb") as f:
        return _Unpickler(f).load()


def retrieve_results(results_folder, subfolder_name, dataset, method, coreset_size, trial=0,
                     fnm: str = "results"):
    """Warm-start retrieval for ``load_saved_coreset`` (ref
    ``inference/utils.py:1800-1823``): the stored coreset of (dataset,
    method, coreset_size, trial) of a saved run. ``fnm`` must match the
    name the run was saved under."""
    res = load_results(os.path.join(results_folder, subfolder_name), fnm=fnm)
    node = res[dataset][method][coreset_size][trial]
    return {
        "chosen_indices": node.get("chosen_indices", []),
        "weights": np.asarray(node["vs"][-1]) if node.get("vs") else None,
        "alpha": np.asarray(node["alpha"][-1]) if node.get("alpha") else 0.0,
        "labels": np.asarray(node["zs"][-1]) if node.get("zs") else None,
        "us": np.asarray(node["us"][-1]) if node.get("us") else None,
    }
