from .model import PiecewiseModel, SMCModel, model_from_dict  # noqa: F401
