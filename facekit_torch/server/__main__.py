from facekit_torch.server.app import main

if __name__ == "__main__":
    main()
