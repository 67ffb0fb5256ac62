from autorag_research_tpu_torch.cli.app import main

if __name__ == "__main__":
    raise SystemExit(main())
