from repro_torch.train.steps import (
    StepBundle, load_state, make_opt, make_step_bundle, serve_input_specs,
    train_input_specs,
)

__all__ = ["StepBundle", "make_step_bundle", "make_opt", "load_state",
           "train_input_specs", "serve_input_specs"]
