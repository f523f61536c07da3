from .api import LM, build_model, params_from_reference

__all__ = ["LM", "build_model", "params_from_reference"]
