from sparse_matrix_fine_tuning_torch.interventions.causal_model import CausalModel
from sparse_matrix_fine_tuning_torch.interventions.das import (
    interchange_accuracy,
    train_das,
)
from sparse_matrix_fine_tuning_torch.interventions.pyvene_io import (
    load_pyvene_interventions,
    save_pyvene_interventions,
)
from sparse_matrix_fine_tuning_torch.interventions.reft import (
    ConsreftIntervention,
    LoreftIntervention,
    LowRankRotatedSpaceIntervention,
    MoReIntervention,
    NoIntervention,
    NoreftIntervention,
    ReftConfig,
    ReftModel,
    RotatedSpaceIntervention,
    get_reft_model,
)

__all__ = [
    "CausalModel",
    "ConsreftIntervention",
    "LoreftIntervention",
    "LowRankRotatedSpaceIntervention",
    "MoReIntervention",
    "NoIntervention",
    "NoreftIntervention",
    "ReftConfig",
    "ReftModel",
    "RotatedSpaceIntervention",
    "get_reft_model",
    "interchange_accuracy",
    "load_pyvene_interventions",
    "train_das",
    "save_pyvene_interventions",
]
