from . import controller, patch_match, fusion, meshing, io  # noqa: F401
