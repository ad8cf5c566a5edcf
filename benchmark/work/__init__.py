"""Operations and bytes of each architecture, counted from its shapes."""
