from repro_torch.utils.trees import (
    StackFlattenSpec,
    stack_flatten_spec,
    flatten_stacked,
    unflatten_rows,
    unflatten_vector,
    tree_flatten_vector,
    tree_unflatten_vector,
    tree_global_norm,
    tree_add,
    tree_sub,
    tree_scale,
    tree_weighted_mean,
    tree_zeros_like,
    tree_num_params,
    tree_bytes,
    tree_cast,
)
from repro_torch.utils.prng import PRNGSequence
