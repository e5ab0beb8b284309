from .model_io import read_model, write_model  # noqa: F401
from .data_io import read_data, write_data  # noqa: F401
from .startup import HMCConfig, read_startup  # noqa: F401
