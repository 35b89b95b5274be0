"""``hierarchy_build_s`` (layer ``setup``: ``core/hierarchy.py``,
``ops/galerkin.py``; host clock): the ``openmg_tpu_torch.setup`` call,
ended by a device synchronize.  Moves ``setup_s``."""


def read(run):
    return run.spans["hierarchy_build_s"]
