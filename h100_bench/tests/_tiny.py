"""Tiny sizes of the benchmark's cells, for the CPU tests."""


def tiny(cell):
    cell.config["dataset"].update(nx=16, ny=6, num_trajectories=4)
    cell.config["train_config"].update(batch_size=4, hidden_dim=16, layers=2)
    cell.traffic["trace_steps"] = 2
    cell.traffic["trace_requests"] = 1
    cell.traffic["check_requests"] = 2
    if "num_trajectories" in cell.traffic.get("dataset", {}):
        cell.traffic["dataset"] = {**cell.traffic["dataset"], "num_trajectories": 3}


def load_run():
    import importlib.util

    from h100_bench import harness

    spec = importlib.util.spec_from_file_location("h100_bench_run", harness.BENCH_DIR / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
