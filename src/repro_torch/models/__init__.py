from .lstm import (LSTMModel, LSTMConfig, LSTM_CONFIGS, params_from_numpy,
                   packed_from_numpy, packed_q8_from_numpy,
                   masked_dense_from_numpy, quant_plan_from_scales)

__all__ = ["LSTMModel", "LSTMConfig", "LSTM_CONFIGS", "params_from_numpy",
           "packed_from_numpy", "packed_q8_from_numpy",
           "masked_dense_from_numpy", "quant_plan_from_scales"]
