from membrane_solver_tpu_torch.visualization.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
