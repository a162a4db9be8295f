from repro_torch.models.transformer import (
    init_model,
    forward,
    init_cache,
    decode_step,
    ENC_MEMORY_LEN,
)
from repro_torch.models.cnn import init_cnn, cnn_forward, cnn_loss, cnn_accuracy
from repro_torch.models.registry import (ModelDef, model_def_for,
                                         register_model_def,
                                         register_workload, workload_config,
                                         workload_names)
