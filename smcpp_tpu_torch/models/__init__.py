from .model import (  # noqa: F401
    PiecewiseModel,
    SMCModel,
    SMCTwoPopulationModel,
    model_from_dict,
)
