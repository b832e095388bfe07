"""Host-side data loading of the port: manifests, eval transforms, EvalLoader."""
