from lanczos_tpu_torch.cli import main

main()
