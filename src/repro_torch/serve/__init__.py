from repro_torch.serve.serve_step import ServeStepBuilder, greedy_sample
