from vse_tpu_torch.sync.cli import main

main()
