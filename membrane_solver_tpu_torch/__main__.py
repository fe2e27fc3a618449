from membrane_solver_tpu_torch.cli import main

raise SystemExit(main())
