from .lstm import (LSTMModel, LSTMConfig, LSTM_CONFIGS, params_from_numpy,
                   packed_from_numpy)

__all__ = ["LSTMModel", "LSTMConfig", "LSTM_CONFIGS", "params_from_numpy",
           "packed_from_numpy"]
