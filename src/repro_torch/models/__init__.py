from .api import LM, build_model, cache_specs, input_specs, params_from_reference

__all__ = ["LM", "build_model", "cache_specs", "input_specs", "params_from_reference"]
