"""Command-line entry points of the port and what they stand on: `serve`
(batched LM serving), `train` (the training CLI), `steps` (the step
functions and abstract input specs) and `mesh` (device meshes)."""
